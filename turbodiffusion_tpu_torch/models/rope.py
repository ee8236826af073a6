"""3D video RoPE angles for the Wan DiT, and the Q/K channel permutation.

Ports `rope_freqs_3d` (`turbodiffusion_tpu/models/rope.py:17-55`),
`rope_channel_permutation` (:104-116) and `permute_qk_linear` (:119-149).
The port keeps the JAX package's convention: rotate-half RoPE, whose Q/K
channel permutation is applied to the projection weights once at checkpoint
import, so JAX parameters carry over 1:1.
"""

from __future__ import annotations

import torch

from turbodiffusion_tpu_torch.ops.quant import (
    QBLOCK, Int8BlockLinear, Int8Linear, quantize_int8_block)


def rope_freqs_3d(T: int, H: int, W: int, head_dim: int,
                  device=None,
                  h_extrapolation_ratio: float = 1.0,
                  w_extrapolation_ratio: float = 1.0,
                  t_extrapolation_ratio: float = 1.0) -> torch.Tensor:
    """Angles (T*H*W, head_dim//2) in fp32, concatenated [t | h | w]
    (rope.py:17-55; head_dim = dim_t + 2*dim_h with dim_h = head_dim//6*2)."""
    dim = head_dim
    dim_h = dim // 6 * 2
    dim_w = dim_h
    dim_t = dim - 2 * dim_h

    h_ntk = h_extrapolation_ratio ** (dim_h / (dim_h - 2))
    w_ntk = w_extrapolation_ratio ** (dim_w / (dim_w - 2))
    t_ntk = t_extrapolation_ratio ** (dim_t / (dim_t - 2))

    def axis_freqs(n, d, theta):
        rng = torch.arange(0, d, 2, dtype=torch.float32,
                           device=device)[: d // 2] / d
        inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                           device=device), rng)
        return torch.outer(torch.arange(n, dtype=torch.float32,
                                        device=device), inv)

    ft = axis_freqs(T, dim_t, 10000.0 * t_ntk)[:, None, None, :]
    fh = axis_freqs(H, dim_h, 10000.0 * h_ntk)[None, :, None, :]
    fw = axis_freqs(W, dim_w, 10000.0 * w_ntk)[None, None, :, :]
    freqs = torch.cat([ft.expand(T, H, W, dim_t // 2),
                       fh.expand(T, H, W, dim_h // 2),
                       fw.expand(T, H, W, dim_w // 2)], dim=-1)
    return freqs.reshape(T * H * W, dim // 2)


def rope_channel_permutation(head_dim: int, num_heads: int) -> torch.Tensor:
    """The permutation from the reference's interleaved channel order to
    the rotate-half order, per head: [0, 2, 4, ..., 1, 3, 5, ...] (rope.py:
    104-116). Applied to the output channels of the Q / K projections and
    to norm_q / norm_k; attention scores are unchanged, as q and k get the
    same permutation."""
    half = head_dim // 2
    per_head = torch.cat([torch.arange(half) * 2, torch.arange(half) * 2 + 1])
    return (per_head[None, :] + torch.arange(num_heads)[:, None] * head_dim
            ).reshape(-1)


@torch.no_grad()
def permute_qk_linear(lin, head_dim: int, num_heads: int,
                      inverse: bool = False):
    """Permute a Q / K projection's output channels into rotate-half order
    (or back, inverse=True), in place (rope.py:119-149). lin is an
    nn.Linear, an Int8Linear (postscale: the per-channel scales permute with
    the rows) or an Int8BlockLinear (128x128 block scales: with heads of a
    multiple of 128 the permutation stays inside each block and only the
    rows move; heads that straddle blocks are dequantised, permuted and
    requantised with `quantize_int8_block`). Returns lin."""
    perm = rope_channel_permutation(head_dim, num_heads)
    if inverse:
        perm = torch.argsort(perm)
    if isinstance(lin, Int8BlockLinear) and head_dim % QBLOCK:
        N, K = lin.w_int8.shape
        sr = lin.scale.repeat_interleave(QBLOCK, 0)[:N]
        sr = sr.repeat_interleave(QBLOCK, 1)[:, :K]
        lin.w_int8, lin.scale = quantize_int8_block(
            (lin.w_int8.float() * sr)[perm.to(sr.device)])
    elif isinstance(lin, (Int8Linear, Int8BlockLinear)):
        lin.w_int8 = lin.w_int8[perm.to(lin.w_int8.device)].contiguous()
        if isinstance(lin, Int8Linear):
            lin.scale = lin.scale[perm.to(lin.scale.device)].contiguous()
    else:
        lin.weight.copy_(lin.weight[perm.to(lin.weight.device)])
    if lin.bias is not None:
        lin.bias.copy_(lin.bias[perm.to(lin.bias.device)])
    return lin
