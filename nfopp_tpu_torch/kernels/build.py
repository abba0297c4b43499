"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` is compiled for `sm_90a` by its own `nvcc` process, all
started together, and the objects are linked into one shared library with a
plain C interface. The library is keyed on a hash of the sources and flags
and cached under `kernels/build/`, so a checkout builds everything the first
time a kernel is launched and an edited source rebuilds. Nothing here runs at
import time; the CPU tests never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["load_library", "library_path", "check"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of the C entry points (csrc/*.cu); each returns its launch's
# cudaGetLastError(). Structs (NetArgs, Grads) and the stream pass as pointers;
# an int `bf16` selects a kernel's bf16 instantiation.
PROTOTYPES = {
    "nf_onf_forward": [_P, _P, _I, _I, _I, _P, _P],
    "nf_field_grad": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "nf_collision_fwd": [_P, _P, _P, _I, _I, _I, _F, _I, _P, _P],
    "nf_collision_bwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P],
    "nf_onf_multi": [_P, _P, _I, _I, _I, _I, _P, _P],
    "nf_field_grad_multi": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libnfopp_kernels_{digest.hexdigest()[:16]}.so"


def _build(target: pathlib.Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        lib = pathlib.Path(tmp) / target.name
        link = [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)]
        result = subprocess.run(link, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{result.stdout}{result.stderr}")
        (BUILD_DIR / (target.stem + ".log")).write_text("\n".join(log))
        os.replace(lib, target)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, its entry points declared."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.nf_error_string.argtypes = [ctypes.c_int]
            lib.nf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if code != 0:
        message = load_library().nf_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({message})")
