"""Build and bind the port's CUDA kernels.

Every `*.cu` file under `turbodiffusion_tpu_torch/csrc/` is compiled by
`nvcc` for `sm_90a` (one `nvcc` process per source, all started together)
and linked into ONE shared library with a plain C interface, loaded with
`ctypes`. Nothing includes PyTorch's headers, so the build takes seconds.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_PI64 = ctypes.POINTER(ctypes.c_int64)

# C signatures: name -> argtypes (every function returns int, the CUDA error)
SIGNATURES = {
    # x, out, mod_scale, mod_shift, weight, bias, rows, L, D, eps, stream
    "tdx_modulated_layer_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # x, out int8, out scales, mod_scale, mod_shift, weight, bias, rows, L, D,
    # eps, stream
    "tdx_modulated_layer_norm_quant": [_P] * 7 + [_I] * 3 + [_F, _P],
    # x, out, weight, cos_full, sin_full, x row stride, rows, L, H, Dh, eps,
    # stream
    "tdx_rmsnorm_rope": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _F, _P],
    # 1 when K1 / K12 / K2 take their warp-per-row kernel for these
    # arguments: x, out, mod_scale, mod_shift, weight, bias, D; x, out,
    # weight, cos_full, sin_full, x row stride, H, Dh
    "tdx_modulated_layer_norm_form": [_P] * 6 + [_I],
    "tdx_modulated_layer_norm_quant_form": [_P] * 6 + [_I],
    "tdx_rmsnorm_rope_form": [_P] * 5 + [_I64, _I, _I],
    # q, k, v, o, lut, B, H, Lq, kv_len, nQ, sel, block_q, block_k,
    # 12 strides (q, k, v, o: batch, token, head), scale, stream
    "tdx_sparse_flash_attention": [_P, _P, _P, _P, _P] + [_I] * 8
                                  + [_I64] * 12 + [_F, _P],
    # the form K3 takes (1 wgmma, 0 mma.sync, -1 refused): block_q,
    # block_k, kv_len, int64[12] strides
    "tdx_sparse_flash_attention_form": [_I, _I, _I, _PI64],
    # q, k, v, o, lut, int8 Q rows, Q row scales, int8 K rows, K row
    # scales, B, H, Lq, Lk, kv_len, nQ, sel, block_q, block_k, 12 strides,
    # scale, stream (K20)
    "tdx_sparse_flash_attention_i8qk": [_P] * 9 + [_I] * 9 + [_I64] * 12
                                       + [_F, _P],
    # the form K20 takes (1 wgmma, -1 refused): block_q, block_k, kv_len,
    # Lk, int64[12] strides
    "tdx_sparse_flash_attention_i8qk_form": [_I] * 4 + [_PI64],
    # q, k, v, o, B, H, Lq, kv_len, 12 strides, scale, stream
    "tdx_flash_attention": [_P, _P, _P, _P] + [_I] * 4 + [_I64] * 12
                           + [_F, _P],
    # q, k, v, o, int8 Q rows, Q row scales, int8 K rows, K row scales, B,
    # H, Lq, Lk, kv_len, 12 strides, scale, stream (K30)
    "tdx_flash_attention_i8qk": [_P] * 8 + [_I] * 5 + [_I64] * 12 + [_F, _P],
    # q, norm_w, k, v, out int8, out scales, q row stride, B, H, heads a
    # block, Lq, kv_len, 6 strides (k, v: batch, token, head), scale, eps,
    # stream
    "tdx_cross_attention_qout": [_P] * 6 + [_I64] + [_I] * 5 + [_I64] * 6
                                + [_F, _F, _P],
    # H, heads a block, kv_len, out: int[6] (cluster blocks, ring stages,
    # key chunks, consumer 0's chunks, shared memory bytes, Q tiles); K14 /
    # K17
    "tdx_cross_attention_qout_shape": [_I, _I, _I, _P],
    # q, norm_w, row rms inverse, k, v, out int8, out scales, q row stride,
    # B, H, heads a block, Lq, kv_len, 6 strides, scale, stream
    "tdx_cross_attention_qout_wide": [_P] * 7 + [_I64] + [_I] * 5
                                     + [_I64] * 6 + [_F, _P],
    # x, weight, row rms inverse, cos, sin, bf16, i8, scale, partial, pooled,
    # counters, the rows' rms inverse out (or null), x row stride, B, L, Lp,
    # H, pool, nP, eps, stream
    "tdx_head_planes": [_P] * 12 + [_I64] + [_I] * 6 + [_F, _P],
    # 1 when K5's warp-per-row kernel takes these arguments, 0 when the entry
    # refuses them: x, weight, cos, sin, bf16, i8, partials, x row stride, H
    "tdx_head_planes_form": [_P] * 7 + [_I64, _I],
    # x, out, x row stride, rows, W, eps, stream
    "tdx_row_rms_inv": [_P, _P, _I64, _I, _I, _F, _P],
    # k, mu, v, kp, vtp, ks, partials, kv, ksum (the last three null: the
    # linear branch off), B, H, Lp, block_k, kv_len, blocks (the partials' 2 x
    # blocks slots), stream
    "tdx_subquant_pack_kvt": [_P] * 9 + [_I] * 6 + [_P],
    # blocks of a K6 launch (0: refused): B, H, Lp, block_k, linear_kv
    "tdx_subquant_pack_kvt_grid": [_I] * 5,
    # k, mu, v, kvi, ks, B*H, Lp, stream
    "tdx_subquant_pack_kv": [_P] * 5 + [_I] * 2 + [_P],
    # k, mu, v, kvi, block scales, B, H, Lp, block_k, kv_len, stream (K27)
    "tdx_subquant_pack_kv_blocks": [_P] * 5 + [_I] * 5 + [_P],
    # planes, mu, int8 planes, row scales, B*H, Lp, stream (K29)
    "tdx_subquant_planes": [_P] * 4 + [_I] * 2 + [_P],
    # k, v, partials (2 x blocks), kv, ksum, B, H, kv_len, blocks,
    # 6 strides (k, v: batch, head, row), stream
    "tdx_linear_kv": [_P] * 5 + [_I] * 4 + [_I64] * 6 + [_P],
    # blocks of a K21 kv launch (0: refused): B, H, kv_len
    "tdx_linear_kv_grid": [_I] * 3,
    # the form K21 takes (1 wgmma, -1 refused): q, k, v, out, B, H, Lq,
    # kv_len, int64[12] strides (q, k, v, out: batch, head, row)
    "tdx_linear_form": [_P] * 4 + [_I] * 4 + [_PI64],
    # q, kvw, ksum, bias, out, B, H, Lq, 6 strides (q, out: batch, head,
    # row), stream
    "tdx_linear_apply": [_P] * 5 + [_I] * 3 + [_I64] * 6 + [_P],
    # planes, xq, row scales, B, L, Lp, H, Dh, stream
    "tdx_unfold_quant": [_P] * 3 + [_I] * 5 + [_P],
    "tdx_unfold_quant_wide": [_P] * 3 + [_I] * 5 + [_P],
    # qi, qs, kp, vtp, ks, vch, lut, kvw, ks_bias, out,
    # B, H, Lp, Lkp, kv_len, nQ, sel, block_q, block_k, scale*log2e, stream
    "tdx_sparse_attention_i8_vt": [_P] * 10 + [_I] * 9 + [_F, _P],
    # qi, qs, kvi, ks, vs, lut, out,
    # B, H, Lp, Lkp, kv_len, nQ, sel, block_q, block_k, scale, stream
    "tdx_sparse_attention_i8_planes": [_P] * 7 + [_I] * 9 + [_F, _P],
    # the form K19 takes (1 wgmma, 0 mma.sync, -1 refused): Lp, Lkp,
    # kv_len, block_q, block_k
    "tdx_sparse_attention_i8_planes_form": [_I] * 5,
    # qi, qs, kvi, K block scales, V channel scales, lut, out, the same
    # ints, scale*log2e, stream (K28)
    "tdx_sparse_attention_i8_planes_bs": [_P] * 7 + [_I] * 9 + [_F, _P],
    # the form K28 takes (1 wgmma, 0 mma.sync, -1 refused): Lp, Lkp,
    # kv_len, block_q, block_k
    "tdx_sparse_attention_i8_planes_bs_form": [_I] * 5,
    # x, x row stride, xq, row scales, M, K, stream
    "tdx_quantize_rows_int8": [_P, _I64, _P, _P, _I, _I, _P],
    # xq, w (N, K), row scales, col scales, bias, gate, residual, out,
    # M, N, K, act, stream
    "tdx_int8_gemm_postscale": [_P] * 8 + [_I] * 4 + [_P],
    # xq, w, row scales, col scales, bias, out int8, out scales,
    # M, N, K, scale block, act, stream
    "tdx_int8_gemm_qout": [_P] * 7 + [_I] * 5 + [_P],
    # xq, w, slab scales, col scales, bias, gate, residual, out,
    # M, N, K, slab, act, stream
    "tdx_int8_gemm_blockact": [_P] * 8 + [_I] * 5 + [_P],
    # xq, w (N, K), x block scales (Mb, Kb), w block scales (Nb, Kb), bias,
    # out, out is fp32, M, N, K, stream
    "tdx_int8_gemm_block": [_P] * 6 + [_I] * 4 + [_P],
    # q, k, v, dout, dq, (lse, delta), lut, B, H, Lq, kv_len, nQ, sel,
    # block_q, block_k, 15 strides (q, k, v, dout, dq: batch, token, head),
    # scale, stream
    "tdx_sparse_attention_bwd_dq": [_P] * 7 + [_I] * 8 + [_I64] * 15
                                   + [_F, _P],
    # q, k, v, dout, (lse, delta), inverse lut, dk, dv, B, H, Lq, Lk,
    # kv_len, nQ, nK, block_q, block_k, 18 strides (q, k, v, dout, dk, dv),
    # scale, stream
    "tdx_sparse_attention_bwd_dkv": [_P] * 8 + [_I] * 9 + [_I64] * 18
                                    + [_F, _P],
    # the tile rows K23 (pass 0) or K24 (pass 1) take (128, 64, -1 refused):
    # pass, block_q, block_k, kv_len, int64[12] strides (q, k, v, dout)
    "tdx_sparse_attention_bwd_form": [_I, _I, _I, _I, _PI64],
    # q, k, v, dq, dk, dv, o, dout, B, H, Lq, kv_len, 24 strides (q, k, v,
    # dq, dk, dv, o, dout: batch, token, head), scale, stream
    "tdx_flash_attention_jvp": [_P] * 8 + [_I] * 4 + [_PI64, _F, _P],
    # the same with the lut after dout and nQ, sel, block_q, block_k after
    # kv_len
    "tdx_sparse_flash_attention_jvp": [_P] * 9 + [_I] * 8 + [_PI64, _F, _P],
    # the form K25 / K26 take (1 wgmma, 0 mma.sync, -1 refused): block_q,
    # block_k (both 0: the dense launch), kv_len, int64[24] strides
    "tdx_flash_attention_jvp_form": [_I, _I, _I, _PI64],
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in srcs if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for name, proc in procs:
            out = proc.communicate()[0]
            log += f"[{name}]\n{out}"
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(lib, so)
    return KernelLibrary(so, time.perf_counter() - t0, log)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    """PyTorch's current stream on t's device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
