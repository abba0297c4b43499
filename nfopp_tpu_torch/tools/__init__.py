"""Drivers of the port on a CUDA card: the main path's car scene and the
per-step profiler (`python3 -m nfopp_tpu_torch.tools.profile_step`)."""
