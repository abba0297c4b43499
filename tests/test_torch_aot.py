"""The port's captured programs (nfopp_tpu_torch/utils/aot.py) and the kernel
library's build step (utils/compile_cache.py): the cases of
tests/test_aot.py that carry over to a process-local store of CUDA graphs.

Key semantics as JAX's: deterministic, sensitive to the config, the batch
and the name, and to the code's identity; content_digest covers tensor and
array contents, shape_digest only structure, shapes, dtypes and devices. On
the CPU (the caller asked for it) aot_or_compile returns `fn` itself, not
loaded, as JAX's does on a CPU backend; the capture itself runs on the card
(chip_smoke.py phase 14). JAX's save/load/path cases have no counterpart: a
CUDA graph cannot outlive its process.
"""
import numpy as np
import pytest
import torch

from nfopp_tpu.solver import SolverConfig as JaxSolverConfig
from nfopp_tpu.utils.aot import aot_key as jax_aot_key
from nfopp_tpu_torch.solver import SolverConfig
from nfopp_tpu_torch.utils import aot as aot_mod
from nfopp_tpu_torch.utils import enable_compile_cache
from nfopp_tpu_torch.utils.aot import (
    AotProgram,
    aot_key,
    aot_or_compile,
    content_digest,
    shape_digest,
    source_digest,
)
from nfopp_tpu_torch.utils.tree import tree_copy_
from torch_threads import one_thread  # noqa: F401


def test_key_is_deterministic_and_config_sensitive():
    c1 = SolverConfig(trajectory_length=32)
    c2 = SolverConfig(trajectory_length=64)
    k1 = aot_key("bench-run", c1, 256, 200)
    assert k1 == aot_key("bench-run", c1, 256, 200)
    assert k1 != aot_key("bench-run", c2, 256, 200)
    assert k1 != aot_key("bench-run", c1, 512, 200)
    assert k1 != aot_key("other", c1, 256, 200)
    assert k1.startswith("bench-run-")
    # the same contract as JAX's keys, whose shape is name + 16 hex digits
    jax_key = jax_aot_key("bench-run", JaxSolverConfig(trajectory_length=32), 256, 200)
    assert len(k1) == len(jax_key) and k1.split("-")[:2] == jax_key.split("-")[:2]


def test_key_includes_code_identity(monkeypatch):
    base = aot_key("code-ident", 1)
    assert source_digest() == source_digest()  # cached and deterministic
    monkeypatch.setattr(aot_mod, "_SOURCE_DIGEST_CACHE", "deadbeefdeadbeef")
    assert aot_key("code-ident", 1) != base


def test_source_digest_covers_the_kernel_sources(monkeypatch):
    """A .cu edit changes the digest as a .py edit does."""
    base = source_digest()
    csrc = aot_mod._PACKAGE / "kernels" / "csrc"
    real = type(csrc).read_bytes

    def edited(path):
        data = real(path)
        return data + b"//" if path.parent == csrc and path.suffix == ".cu" else data

    monkeypatch.setattr(aot_mod, "_SOURCE_DIGEST_CACHE", None)
    monkeypatch.setattr(type(csrc), "read_bytes", edited)
    assert source_digest() != base


def test_content_digest_covers_contents_and_shape_digest_ignores_values():
    a = {"pts": torch.zeros((4, 2)), "r": np.float32(0.3)}
    b = {"pts": torch.zeros((4, 2)), "r": np.float32(0.3)}
    assert content_digest(a) == content_digest(b)
    b["pts"] = b["pts"] + 1.0
    assert content_digest(a) != content_digest(b)
    # dtype or shape changes alone also miss
    assert content_digest(a) != content_digest({"pts": torch.zeros((4, 2), dtype=torch.float64),
                                                "r": np.float32(0.3)})
    assert content_digest(a) != content_digest({"pts": torch.zeros((2, 4)),
                                                "r": np.float32(0.3)})
    # numpy arrays and bf16 tensors are contents too
    assert content_digest(np.ones(3)) != content_digest(np.zeros(3))
    assert (content_digest(torch.ones(3, dtype=torch.bfloat16))
            != content_digest(torch.zeros(3, dtype=torch.bfloat16)))

    assert shape_digest(a) == shape_digest(b)  # values differ, structure does not
    assert shape_digest({"pts": torch.zeros((4, 3))}) != shape_digest({"pts": torch.zeros((4, 2))})
    assert (shape_digest({"pts": torch.zeros(2, dtype=torch.int32)})
            != shape_digest({"pts": torch.zeros(2)}))
    assert shape_digest({"a": torch.zeros(2)}) != shape_digest({"b": torch.zeros(2)})
    assert shape_digest((torch.zeros(2),)) != shape_digest([torch.zeros(2)])


def test_aot_or_compile_on_the_cpu_returns_fn_itself_bit_for_bit():
    def fn(x, n):
        return torch.sin(x) * n, x.sum()

    x = torch.linspace(0.0, 1.0, 7)
    program = aot_or_compile("cpu-program", fn, (x, 3.0), "k")
    assert isinstance(program, AotProgram)
    assert program.fn is fn and not program.loaded and program.seconds == 0.0
    assert program.key == aot_key("cpu-program", "k")
    want, got = fn(x, 3.0), program(x, 3.0)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    # nothing is stored on the CPU: a second request is not loaded either
    assert not aot_or_compile("cpu-program", fn, (x, 3.0), "k").loaded
    assert not aot_or_compile("cpu-program", fn, (x, 3.0), "k", enabled=False).loaded
    assert aot_or_compile("cpu-program", fn, (x, 3.0), "other").key != program.key


def test_capture_refuses_a_cpu_generator():
    """A captured program draws on the card: the error names the fix."""
    with pytest.raises(ValueError, match=r"torch.Generator\(device='cuda'\)"):
        aot_mod._static_copy(torch.Generator().manual_seed(0), torch.device("cuda"))


def test_compile_cache_is_off_on_the_cpu():
    assert enable_compile_cache("cpu") is False


def test_compile_cache_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enable_compile_cache()


def test_tree_copy_reads_no_overwritten_source():
    """The chunk program's copy-back: a source leaf that is another leaf's
    destination (prev_trajectory <- the input trajectory) is copied aside."""
    dst = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([3.0, 4.0]),
           "c": torch.tensor([5.0, 6.0])}
    src = {"a": torch.tensor([7.0, 8.0]), "b": dst["a"], "c": dst["c"]}
    out = tree_copy_(dst, src)
    assert out is dst
    assert dst["a"].tolist() == [7.0, 8.0]
    assert dst["b"].tolist() == [1.0, 2.0]  # the old a, not the new one
    assert dst["c"].tolist() == [5.0, 6.0]
