"""Two API gaps of the port closed against the JAX package: the field's
parameter count (`models.onf_param_count`, pinned at 33,141 by
tests/test_onf.py:13) for the ONF configurations the tests build, and the
`ops` package exposing its five submodules as `nfopp_tpu/ops/__init__.py`
does."""
import pytest

import nfopp_tpu.ops as jax_ops
import nfopp_tpu_torch.ops as port_ops
from nfopp_tpu.models import ONFConfig as JaxONFConfig
from nfopp_tpu.models import onf_param_count as jax_onf_param_count
from nfopp_tpu_torch.models import ONFConfig, onf_param_count
from torch_threads import one_thread  # noqa: F401

CONFIGS = [
    {},
    {"hidden": 16},
    {"angle_encoding": False},
    {"angle_encoding": False, "hidden": 16},
    {"use_cos": False},
    {"bias": False},
    {"angle_harmonics": 5, "hidden": 24},
    {"use_normal_init": False, "compute_dtype": "bfloat16"},
]


def test_default_field_has_33141_parameters():
    assert onf_param_count() == 33141 == onf_param_count(ONFConfig())


@pytest.mark.parametrize("fields", CONFIGS, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items())
                         or "default")
def test_param_count_equals_jax(fields):
    assert onf_param_count(ONFConfig(**fields)) == jax_onf_param_count(JaxONFConfig(**fields))


@pytest.mark.parametrize("name", ["math", "hessian", "sampling", "losses", "reparametrize"])
def test_ops_exposes_the_same_submodules_as_jax(name):
    assert getattr(jax_ops, name).__name__ == f"nfopp_tpu.ops.{name}"
    assert getattr(port_ops, name).__name__ == f"nfopp_tpu_torch.ops.{name}"
