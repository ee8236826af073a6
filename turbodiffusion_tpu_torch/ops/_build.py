"""Build and bind the port's CUDA kernels.

Every `*.cu` file under `turbodiffusion_tpu_torch/csrc/` is compiled by
`nvcc` for `sm_90a` into ONE shared library with a plain C interface, loaded
with `ctypes`. Nothing includes PyTorch's headers, so the build takes seconds.

The build happens at first use, into `turbodiffusion_tpu_torch/_build/`
(listed in `.gitignore`), under a name keyed on a hash of the sources and
flags: a changed source builds anew, an unchanged one loads the library that
is already there. The library is written under a temporary name and renamed
into place, so concurrent first uses never load a half-written file.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns `cudaGetLastError()`; `check` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C signatures: name -> argtypes (every function returns int, the CUDA error)
SIGNATURES = {
    # x, out, mod_scale, mod_shift, weight, bias, rows, L, D, eps, stream
    "tdx_modulated_layer_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # x, out, weight, cos_full, sin_full, rows, L, H, Dh, eps, stream
    "tdx_rmsnorm_rope": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, o, lut, B, H, Lq, kv_len, nQ, sel, block_q, block_k,
    # 12 strides (q, k, v, o: batch, token, head), scale, stream
    "tdx_sparse_flash_attention": [_P, _P, _P, _P, _P] + [_I] * 8
                                  + [_I64] * 12 + [_F, _P],
    # q, k, v, o, B, H, Lq, kv_len, 12 strides, scale, stream
    "tdx_flash_attention": [_P, _P, _P, _P] + [_I] * 4 + [_I64] * 12
                           + [_F, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "turbodiffusion_tpu_torch need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"libtdx_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return KernelLibrary(so, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return KernelLibrary(so, seconds, log)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    """PyTorch's current stream on t's device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
