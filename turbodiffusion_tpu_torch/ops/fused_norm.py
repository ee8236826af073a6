"""Fused norm + modulation and RMSNorm + RoPE: kernels K1 and K2.

Ports `turbodiffusion_tpu/ops/fused_norm.py`:
  * `modulated_layer_norm` / `modulated_layer_norm_ref` (:43-65, :193-224)
    — K1 `_mln_cuda` replaces the TPU kernel `_mln_pallas` (:96-162);
  * `rmsnorm_rope` / `rmsnorm_rope_ref` (:241-260, :364-381)
    — K2 `_rmsrope_cuda` replaces `_rmsrope_pallas` (:281-325);
  * `rope_cos_sin_full` (:231-238).

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel (csrc/fused_norm.cu) or raises. Each launcher counts its
launches in `.launches`. The int8 `quant_out` form of K1 waits for W8A8.
"""

from __future__ import annotations

import torch

from turbodiffusion_tpu_torch.models.layers import rms_norm
from turbodiffusion_tpu_torch.ops import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1: modulated layer norm
# ---------------------------------------------------------------------------

def modulated_layer_norm_ref(x, mod_scale=None, mod_shift=None, weight=None,
                             bias=None, eps: float = 1e-6):
    """Plain version of K1 (fused_norm.py:43-65). x: (B, L, D);
    mod_scale/mod_shift: (B, 1, D) or (B, D) fp32; weight/bias: (D,). LN in
    fp32, affine in fp32, cast to x.dtype BEFORE the fp32 modulation, cast
    back to x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    if mod_scale is None:
        return y
    B, D = x.shape[0], x.shape[-1]
    ms = mod_scale.reshape(B, 1, D).float()
    mb = mod_shift.reshape(B, 1, D).float()
    return (y.float() * (1.0 + ms) + mb).to(x.dtype)


def _mln_cuda(x, mod_scale, mod_shift, weight, bias, eps: float):
    """Launch K1. x (B, L, D) bf16 contiguous; mod_* (B, D) fp32; weight/bias
    (D,) bf16."""
    B, L, D = x.shape
    _require(x.dtype == torch.bfloat16 and x.is_contiguous(),
             "K1 takes a contiguous bf16 x")
    _require(D % 2 == 0 and D <= 4096, f"K1 takes an even D <= 4096, got {D}")
    args = []
    for t, dt, n in ((mod_scale, torch.float32, B * D),
                     (mod_shift, torch.float32, B * D),
                     (weight, torch.bfloat16, D), (bias, torch.bfloat16, D)):
        if t is None:
            args.append(None)
            continue
        t = t.to(dt).contiguous()
        _require(t.device == x.device and t.numel() == n,
                 "K1 operands must lie on x's device with matching sizes")
        args.append(t)
    _require((args[0] is None) == (args[1] is None),
             "K1 takes mod_scale and mod_shift together")
    out = torch.empty_like(x)
    lib = _build.load()
    rc = lib.tdx_modulated_layer_norm(
        x.data_ptr(), out.data_ptr(),
        *[None if a is None else a.data_ptr() for a in args],
        B * L, L, D, float(eps), _build.stream_ptr(x))
    _build.check(rc, "tdx_modulated_layer_norm")
    _mln_cuda.launches += 1
    return out


_mln_cuda.launches = 0


def modulated_layer_norm(x, mod_scale=None, mod_shift=None, weight=None,
                         bias=None, eps: float = 1e-6):
    """LN (+affine) (+AdaLN modulate) (fused_norm.py:193-224): the plain
    version on a CPU tensor, kernel K1 on a CUDA tensor."""
    if x.device.type == "cpu":
        return modulated_layer_norm_ref(x, mod_scale, mod_shift, weight,
                                        bias, eps)
    _require(x.device.type == "cuda", f"no kernel for device {x.device}")
    B, D = x.shape[0], x.shape[-1]
    ms = None if mod_scale is None else mod_scale.reshape(B, D)
    mb = None if mod_shift is None else mod_shift.reshape(B, D)
    return _mln_cuda(x, ms, mb, weight, bias, eps)


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
    """Launch K2. x (B, L, H*Dh) bf16 contiguous; weight (H*Dh,);
    cos/sin (L, Dh) fp32 or both None (norm only). Returns (B, L, H, Dh)."""
    B, L, HD = x.shape
    H = num_heads
    Dh = HD // H
    _require(x.dtype == torch.bfloat16 and x.is_contiguous(),
             "K2 takes a contiguous bf16 x")
    _require(HD == H * Dh and Dh % 2 == 0 and HD <= 4096,
             f"K2 takes H*Dh <= 4096 with an even Dh, got {H}x{Dh}")
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
        B * L, L, H, Dh, float(eps), _build.stream_ptr(x))
    _build.check(rc, "tdx_rmsnorm_rope")
    _rmsrope_cuda.launches += 1
    return out


_rmsrope_cuda.launches = 0


def rmsnorm_rope(x, weight, cos_full=None, sin_full=None, *, num_heads: int,
                 eps: float = 1e-5):
    """RMSNorm over the full row (+ rotate-half RoPE) (fused_norm.py:364-381).
    x: (B, L, H*Dh) -> (B, L, H, Dh); no tables => norm only (cross Q).
    The plain version on a CPU tensor, kernel K2 on a CUDA tensor."""
    B, L, HD = x.shape
    if x.device.type == "cpu":
        if cos_full is None:
            return rms_norm(x, weight, eps=eps).reshape(
                B, L, num_heads, HD // num_heads)
        return rmsnorm_rope_ref(x, weight, cos_full, sin_full, eps)
    _require(x.device.type == "cuda", f"no kernel for device {x.device}")
    return _rmsrope_cuda(x, weight, cos_full, sin_full, eps, num_heads)
