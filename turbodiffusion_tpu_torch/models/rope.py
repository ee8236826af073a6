"""3D video RoPE angles for the Wan DiT.

Ports `rope_freqs_3d` (`turbodiffusion_tpu/models/rope.py:17-55`). The port
keeps the JAX package's convention: rotate-half RoPE, whose Q/K channel
permutation is applied to the projection weights once at checkpoint import
(rope.py:104-140), so JAX parameters carry over 1:1. The interleaved variant
and the permutation helpers wait for checkpoint import.
"""

from __future__ import annotations

import torch


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
