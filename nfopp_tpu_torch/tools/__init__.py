"""Drivers of the port on a CUDA card: the main path's car scene, the
per-step profiler (`python3 -m nfopp_tpu_torch.tools.profile_step`) and the
field-gradient and collision kernels' timer
(`python3 -m nfopp_tpu_torch.tools.time_kernels`)."""
