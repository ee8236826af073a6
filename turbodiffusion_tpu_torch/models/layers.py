"""Basic layers with the reference's precision discipline.

Ports `turbodiffusion_tpu/models/layers.py:24-94`. Linear weights live in
`nn.Linear` modules (out, in); these helpers keep the fp32 islands:

  * WanRMSNorm: normalise in fp32, cast to x.dtype, THEN multiply by the
    weight (layers.py:32-37) — the cast happens before the weight multiply.
  * WanLayerNorm: fp32 layer norm, output cast to x.dtype (:40-52).
  * Time embedding and projection run in fp32 (:70-94).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """WanRMSNorm (layers.py:32-37): fp32 normalise, cast to x.dtype before
    the elementwise weight multiply."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None):
    """WanLayerNorm (layers.py:40-52): fp32 compute, optional affine, output
    cast to `out_dtype` (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def gelu_tanh(x: torch.Tensor):
    """GELU with the tanh approximation (layers.py:60-63)."""
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor):
    """cat([cos, sin]) of outer(position, 10000^-(arange(half)/half)) in
    fp32 (layers.py:70-79)."""
    if dim % 2:
        raise ValueError(f"dim must be even, got {dim}")
    half = dim // 2
    position = position.float()
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=position.device) / half
    freqs = torch.pow(torch.tensor(10000.0, device=position.device), exponent)
    sinusoid = torch.outer(position, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
