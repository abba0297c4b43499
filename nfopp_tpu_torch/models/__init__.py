from .onf import (  # noqa: F401
    ONFConfig, angle_encode, init_onf_params, onf_apply, onf_param_count, params_from_jax,
)

__all__ = ["ONFConfig", "angle_encode", "init_onf_params", "onf_apply", "onf_param_count",
           "params_from_jax"]
