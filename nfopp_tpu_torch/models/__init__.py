from .onf import ONFConfig, angle_encode, init_onf_params, onf_apply, params_from_jax

__all__ = ["ONFConfig", "angle_encode", "init_onf_params", "onf_apply", "params_from_jax"]
