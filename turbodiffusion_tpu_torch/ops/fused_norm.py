"""Fused norm + modulation and RMSNorm + RoPE: kernels K1, K12 and K2.

Ports `turbodiffusion_tpu/ops/fused_norm.py`:
  * `modulated_layer_norm` / `modulated_layer_norm_ref` (:43-65, :193-224)
    — K1 `_mln_cuda` replaces the TPU kernel `_mln_pallas` (:96-162);
    with `quant_out=True`, K12 `_mln_quant_cuda` replaces its quant-out
    launch (:144, body `_mln_kernel` :68-93): int8 rows with one fp32 scale
    each, the feed of the next W8A8 GEMM; both take rows up to 5120 wide
    (the 14B's dim);
  * `rmsnorm_rope` / `rmsnorm_rope_ref` (:241-260, :364-381)
    — K2 `_rmsrope_cuda` replaces `_rmsrope_pallas` (:281-325), at any
    H*Dh with an even Dh, as the TPU kernel does (the 14B's 5120 among
    them);
  * `rope_cos_sin_full` (:231-238).

K12 and its plain version follow the TPU kernel, not JAX's off-TPU branch
(:205-213, which rounds the modulated value to bf16 and divides by the
scale): the int8 comes from the fp32 modulated value, with K8's rule
(`x * (1/scale)`, `scale = max(amax, 1e-8) * (1/127)`, half to even); the
affine form without modulation (norm3) quantises the bf16-rounded value.

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel (csrc/fused_norm.cu) or raises. Each launcher counts its
launches in `.launches`. K2 reads its input rows through a row stride, so
the q and k column groups of the fused QKV output need no copy. K1, K12 and
K2 run warp-per-row kernels with 16-byte accesses at the shapes `mln_form` /
`mln_quant_form` / `rmsrope_form` call "vector" (every path shape, the
fused QKV column groups included) and block-per-row kernels at the rest
("loop"); the C entry chooses by the same rule, and both forms count as one
launch.

Gradients: K1 (bf16 out) and K2 run inside `torch.autograd.Function`s whose
backward recomputes the plain version and differentiates it
(`recompute_vjp`), JAX's `_make_mln_vjp` (:166-190) and `_make_rmsrope_vjp`
(:329-362); RoPE's tables get no gradient. K12 (int8 out) is
inference-only.
"""

from __future__ import annotations

import torch

from turbodiffusion_tpu_torch.models.layers import rms_norm
from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.quant import quantize_rows_int8_plain


# widest row of K1 / K12 (the 14B's dim; csrc/fused_norm.cu kWidePairs)
# and of K2 (the C entry's limit: any H*Dh the model has)
_MLN_MAX_D = 5120
_RMSROPE_MAX_HD = 1 << 30
# widest row of the warp-per-row kernels (csrc/fused_norm.cu kMaxVecRow)
_VEC_MAX_ROW = 8192


def _aligned16(ptrs) -> bool:
    return all(p is None or p % 16 == 0 for p in ptrs)


def mln_form(D: int, *ptrs) -> str:
    """The kernel a K1 launch takes (csrc/fused_norm.cu `mln_vector`):
    "vector", the warp-per-row kernel, for D a multiple of 8 up to 8192 with
    every operand pointer (x, out, mod_scale, mod_shift, weight, bias; None
    for an absent one) 16-byte aligned; else "loop", the block-per-row
    kernel K12 shares, which reads bf16 pairs and float2 and refuses
    operands off 4-byte alignment (8 for the modulation)."""
    ok = 0 < D <= _VEC_MAX_ROW and D % 8 == 0 and _aligned16(ptrs)
    return "vector" if ok else "loop"


def mln_quant_form(D: int, *ptrs) -> str:
    """The kernel a K12 launch takes (csrc/fused_norm.cu
    `tdx_modulated_layer_norm_quant_form`): K1's rule, with the int8 output
    in out's place; "vector" is `mln_rows_kernel<VPL, true>`, "loop"
    `mln_kernel<true>`."""
    return mln_form(D, *ptrs)


def rmsrope_form(num_heads: int, head_dim: int, ld: int, *ptrs) -> str:
    """The kernel a K2 launch takes (csrc/fused_norm.cu `rmsrope_vector`):
    "vector", the warp-per-row kernel, for a head dim that is a power of two
    from 16 to 256, H*Dh up to 8192, a row stride `ld` that is a multiple of
    8 and every pointer (x, out, weight, cos, sin; None for an absent one)
    16-byte aligned; else "loop", the block-per-row kernel, which takes any
    even head dim."""
    Dh = head_dim
    ok = (16 <= Dh <= 256 and Dh & (Dh - 1) == 0
          and num_heads * Dh <= _VEC_MAX_ROW and ld % 8 == 0 and _aligned16(ptrs))
    return "vector" if ok else "loop"


def recompute_vjp(plain, inputs, needs, grad_out):
    """The backward of a kernel whose forward is `plain(*inputs)`: recompute
    the plain version with autograd on and differentiate it. `needs` says
    which inputs want a gradient (the rest, and None inputs, get None)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(n) if torch.is_tensor(t) else t
                for t, n in zip(inputs, needs)]
        wrt = [a for a, n in zip(args, needs) if n and torch.is_tensor(a)]
        out = plain(*args)
        grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
    return tuple(next(grads) if n and torch.is_tensor(a) else None
                 for a, n in zip(args, needs))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _row_stride(x, what: str) -> int:
    """The element stride between the rows of a (B, L, W) tensor that a
    kernel reads as row * stride: unit stride within a row and batches L rows
    apart, as in a column group (Q, K or V) of the fused (B, L, 3*W) QKV
    GEMM output, which the kernels read in place."""
    B, L, _ = x.shape
    ld = x.stride(1)
    _require(x.stride(2) == 1 and (B == 1 or x.stride(0) == L * ld),
             f"{what} takes rows with a unit last stride, batches L rows apart")
    return ld


# ---------------------------------------------------------------------------
# K1 / K12: modulated layer norm, bf16 or int8 out
# ---------------------------------------------------------------------------

def modulated_layer_norm_ref(x, mod_scale=None, mod_shift=None, weight=None,
                             bias=None, eps: float = 1e-6,
                             quant_out: bool = False):
    """Plain version of K1 and K12 (fused_norm.py:43-65, :68-93). x:
    (B, L, D); mod_scale/mod_shift: (B, 1, D) or (B, D) fp32; weight/bias:
    (D,). LN in fp32, affine in fp32, cast to x.dtype BEFORE the fp32
    modulation, cast back to x.dtype. quant_out: (int8 (B, L, D), fp32
    (B, L, 1)) from the fp32 modulated value instead of the last cast."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype).float()
    if mod_scale is not None:
        B, D = x.shape[0], x.shape[-1]
        ms = mod_scale.reshape(B, 1, D).float()
        mb = mod_shift.reshape(B, 1, D).float()
        y = y * (1.0 + ms) + mb
    if quant_out:
        return quantize_rows_int8_plain(y)
    return y.to(x.dtype)


def _mln_operands(x, mod_scale, mod_shift, weight, bias, what: str):
    """Check K1 / K12's operands: x (B, L, D) bf16 contiguous; mod_* (B, D)
    fp32; weight/bias (D,) bf16. Returns the four as the kernel reads them
    (tensors or None). The caller holds them until the launch: a copy made
    here (a strided modulation at batch > 1) freed before the outputs are
    allocated could become an output's memory, which the kernel then writes
    while it reads the modulation from it."""
    B, L, D = x.shape
    _require(x.dtype == torch.bfloat16 and x.is_contiguous(),
             f"{what} takes a contiguous bf16 x")
    _require(D % 2 == 0 and D <= _MLN_MAX_D,
             f"{what} takes an even D <= {_MLN_MAX_D}, got {D}")
    args = []
    for t, dt, n in ((mod_scale, torch.float32, B * D),
                     (mod_shift, torch.float32, B * D),
                     (weight, torch.bfloat16, D), (bias, torch.bfloat16, D)):
        if t is None:
            args.append(None)
            continue
        t = t.to(dt).contiguous()
        _require(t.device == x.device and t.numel() == n,
                 f"{what} operands must lie on x's device with matching sizes")
        args.append(t)
    _require((args[0] is None) == (args[1] is None),
             f"{what} takes mod_scale and mod_shift together")
    return args


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _mln_cuda(x, mod_scale, mod_shift, weight, bias, eps: float):
    """Launch K1 (bf16 out)."""
    B, L, D = x.shape
    args = _mln_operands(x, mod_scale, mod_shift, weight, bias, "K1")
    out = torch.empty_like(x)
    rc = _build.load().tdx_modulated_layer_norm(
        x.data_ptr(), out.data_ptr(), *_ptrs(args), B * L, L, D, float(eps),
        _build.stream_ptr(x))
    _build.check(rc, "tdx_modulated_layer_norm")
    _mln_cuda.launches += 1
    return out


_mln_cuda.launches = 0


def _mln_quant_cuda(x, mod_scale, mod_shift, weight, bias, eps: float):
    """Launch K12: (int8 (B, L, D), fp32 (B, L, 1))."""
    B, L, D = x.shape
    args = _mln_operands(x, mod_scale, mod_shift, weight, bias, "K12")
    q = torch.empty((B, L, D), dtype=torch.int8, device=x.device)
    s = torch.empty((B, L, 1), dtype=torch.float32, device=x.device)
    rc = _build.load().tdx_modulated_layer_norm_quant(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), *_ptrs(args), B * L, L, D,
        float(eps), _build.stream_ptr(x))
    _build.check(rc, "tdx_modulated_layer_norm_quant")
    _mln_quant_cuda.launches += 1
    return q, s


_mln_quant_cuda.launches = 0


class _MlnFn(torch.autograd.Function):
    """K1 forward, plain-recompute backward."""

    @staticmethod
    def forward(ctx, x, mod_scale, mod_shift, weight, bias, eps: float):
        ctx.save_for_backward(x, mod_scale, mod_shift, weight, bias)
        ctx.eps = eps
        if x.device.type == "cpu":
            return modulated_layer_norm_ref(x, mod_scale, mod_shift, weight,
                                            bias, eps)
        B, D = x.shape[0], x.shape[-1]
        ms = None if mod_scale is None else mod_scale.reshape(B, D)
        mb = None if mod_shift is None else mod_shift.reshape(B, D)
        return _mln_cuda(x, ms, mb, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        plain = lambda *a: modulated_layer_norm_ref(*a, ctx.eps)  # noqa: E731
        return (*recompute_vjp(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:5], g), None)


def modulated_layer_norm(x, mod_scale=None, mod_shift=None, weight=None,
                         bias=None, eps: float = 1e-6,
                         quant_out: bool = False, force_ref: bool = False):
    """LN (+affine) (+AdaLN modulate) (fused_norm.py:193-224): the plain
    version on a CPU tensor, kernel K1 (or K12 with quant_out, returning
    (int8 (B, L, D), fp32 (B, L, 1))) on a CUDA tensor. The bf16 form is
    differentiable in every tensor input. force_ref: the plain version on
    every device (the forward-mode pass, which the kernels' reverse-mode
    Functions do not carry)."""
    _require(x.device.type in ("cpu", "cuda"), f"no kernel for device {x.device}")
    if force_ref:
        return modulated_layer_norm_ref(x, mod_scale, mod_shift, weight,
                                        bias, eps, quant_out)
    if not quant_out:
        return _MlnFn.apply(x, mod_scale, mod_shift, weight, bias, eps)
    if x.device.type == "cpu":
        return modulated_layer_norm_ref(x, mod_scale, mod_shift, weight,
                                        bias, eps, quant_out)
    B, D = x.shape[0], x.shape[-1]
    ms = None if mod_scale is None else mod_scale.reshape(B, D)
    mb = None if mod_shift is None else mod_shift.reshape(B, D)
    return _mln_quant_cuda(x, ms, mb, weight, bias, eps)


# ---------------------------------------------------------------------------
# K2: RMSNorm + rotate-half RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin_full(freqs: torch.Tensor):
    """Angles (L, Dh/2) -> rotate-half tables (cosF, sinF), each (L, Dh):
    cosF = [cos | cos], sinF = [-sin | sin] (fused_norm.py:231-238)."""
    cos = torch.cos(freqs).float()
    sin = torch.sin(freqs).float()
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rmsnorm_rope_ref(x, weight, cos_full, sin_full, eps: float = 1e-5):
    """Plain version of K2 with RoPE (fused_norm.py:241-260): RMS over the
    FULL channel dim in fp32, cast, weight multiply in x.dtype, then
    rotate-half RoPE in fp32. x: (B, L, H*Dh) -> (B, L, H, Dh)."""
    B, L, HD = x.shape
    Dh = cos_full.shape[-1]
    H = HD // Dh
    xf = x.float()
    rms = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = ((xf * rms).to(x.dtype) * weight.to(x.dtype)).reshape(B, L, H, Dh)
    yf = y.float()
    half = torch.cat([yf[..., Dh // 2:], yf[..., :Dh // 2]], -1)
    out = yf * cos_full[None, :, None, :] + half * sin_full[None, :, None, :]
    return out.to(x.dtype)


def _rmsrope_cuda(x, weight, cos_full, sin_full, eps: float, num_heads: int):
    """Launch K2. x (B, L, H*Dh) bf16 with rows `_row_stride` apart;
    weight (H*Dh,); cos/sin (L, Dh) fp32 or both None (norm only). Returns
    (B, L, H, Dh)."""
    B, L, HD = x.shape
    H = num_heads
    Dh = HD // H
    _require(x.dtype == torch.bfloat16, "K2 takes a bf16 x")
    ld = _row_stride(x, "K2")
    _require(HD == H * Dh and Dh % 2 == 0 and HD <= _RMSROPE_MAX_HD,
             f"K2 takes H*Dh <= 2^30 with an even Dh, got {H}x{Dh}")
    w = weight.to(torch.bfloat16).contiguous()
    _require(w.device == x.device and w.numel() == HD,
             "K2 weight must lie on x's device with H*Dh entries")
    rope = cos_full is not None
    _require(rope == (sin_full is not None), "K2 takes cos and sin together")
    if rope:
        cos_full = cos_full.float().contiguous()
        sin_full = sin_full.float().contiguous()
        _require(cos_full.shape == (L, Dh) and sin_full.shape == (L, Dh)
                 and cos_full.device == x.device,
                 f"K2 tables must be ({L}, {Dh}) on x's device")
    out = torch.empty((B, L, H, Dh), dtype=x.dtype, device=x.device)
    lib = _build.load()
    rc = lib.tdx_rmsnorm_rope(
        x.data_ptr(), out.data_ptr(), w.data_ptr(),
        cos_full.data_ptr() if rope else None,
        sin_full.data_ptr() if rope else None,
        ld, B * L, L, H, Dh, float(eps), _build.stream_ptr(x))
    _build.check(rc, "tdx_rmsnorm_rope")
    _rmsrope_cuda.launches += 1
    return out


_rmsrope_cuda.launches = 0


def _rmsrope_plain(x, weight, cos_full, sin_full, eps: float,
                   num_heads: int):
    """K2's plain version, norm only without tables."""
    B, L, HD = x.shape
    if cos_full is None:
        return rms_norm(x, weight, eps=eps).reshape(B, L, num_heads,
                                                    HD // num_heads)
    return rmsnorm_rope_ref(x, weight, cos_full, sin_full, eps)


class _RmsRopeFn(torch.autograd.Function):
    """K2 forward, plain-recompute backward (no gradient to the tables)."""

    @staticmethod
    def forward(ctx, x, weight, cos_full, sin_full, eps: float,
                num_heads: int):
        ctx.save_for_backward(x, weight)
        ctx.args = (cos_full, sin_full, eps, num_heads)
        if x.device.type == "cpu":
            return _rmsrope_plain(x, weight, cos_full, sin_full, eps,
                                  num_heads)
        return _rmsrope_cuda(x, weight, cos_full, sin_full, eps, num_heads)

    @staticmethod
    def backward(ctx, g):
        plain = lambda x, w: _rmsrope_plain(x, w, *ctx.args)  # noqa: E731
        return (*recompute_vjp(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g),
                None, None, None, None)


def rmsnorm_rope(x, weight, cos_full=None, sin_full=None, *, num_heads: int,
                 eps: float = 1e-5, force_ref: bool = False):
    """RMSNorm over the full row (+ rotate-half RoPE) (fused_norm.py:364-381).
    x: (B, L, H*Dh) -> (B, L, H, Dh); no tables => norm only (cross Q).
    The plain version on a CPU tensor, kernel K2 on a CUDA tensor;
    differentiable in x and weight. force_ref: the plain version on every
    device (the forward-mode pass)."""
    _require(x.device.type in ("cpu", "cuda"), f"no kernel for device {x.device}")
    if force_ref:
        return _rmsrope_plain(x, weight, cos_full, sin_full, eps, num_heads)
    return _RmsRopeFn.apply(x, weight, cos_full, sin_full, eps, num_heads)
