"""Batched tensor ops of the solver (ports of `nfopp_tpu/ops`)."""
