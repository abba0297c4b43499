"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel on the
main path, each beside its plain PyTorch version.

| TPU kernel (nfopp_tpu/experimental/pallas/)  | wrapper                          |
| onf_fused.py::_onf_kernel                    | onf_forward.onf_forward          |
| field_grad.py::_kernel                       | field_grad.field_grad            |
| collision_terms.py::_fwd_kernel/_bwd_kernel  | collision_terms.collision_terms  |

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from `csrc/` at first use) or raises.
"""
from .collision_terms import collision_terms, collision_terms_plain
from .common import LAUNCHES, reset_launches
from .field_grad import field_grad, field_grad_plain
from .onf_forward import onf_forward, onf_forward_plain

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "onf_forward",
    "onf_forward_plain",
    "field_grad",
    "field_grad_plain",
    "collision_terms",
    "collision_terms_plain",
]
