"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel, each
beside its plain PyTorch version.

| TPU kernel (nfopp_tpu/experimental/pallas/)  | wrapper                            |
| onf_fused.py::_onf_kernel                    | onf_forward.onf_forward            |
| field_grad.py::_kernel                       | field_grad.field_grad              |
| collision_terms.py::_fwd_kernel/_bwd_kernel  | collision_terms.collision_terms    |
| onf_multi.py::_kernel                        | onf_multi.onf_multi                |
| field_grad_multi.py::_kernel                 | field_grad_multi.field_grad_multi  |

The first three are the production solver's field passes, in f32 or in
bf16 with `onf_apply`'s casts (launches counted under "<name>_bf16"). The
last two are the batch-explicit solve's
(`experimental.ExperimentalConstrainedSolver.run_batch`), in f32 or bf16 with
the TPU multi-problem kernels' casts.

One kernel replaces no TPU kernel: `adam.adam_leaves`, the optimizer's
update of a whole parameter tree in one launch (XLA fuses optax's update on
the TPU), f32 on every path.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from `csrc/` at first use) or raises.
"""
from .adam import adam_leaves, adam_leaves_plain
from .collision_terms import collision_terms, collision_terms_plain
from .common import LAUNCHES, reset_launches
from .field_grad import field_grad, field_grad_plain
from .field_grad_multi import field_grad_multi, field_grad_multi_plain
from .onf_forward import onf_forward, onf_forward_plain
from .onf_multi import onf_multi, onf_multi_plain

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "onf_forward",
    "onf_forward_plain",
    "field_grad",
    "field_grad_plain",
    "collision_terms",
    "collision_terms_plain",
    "onf_multi",
    "onf_multi_plain",
    "field_grad_multi",
    "field_grad_multi_plain",
    "adam_leaves",
    "adam_leaves_plain",
]
