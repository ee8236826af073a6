"""Attention backends: dense and SLA (sparse-linear attention).

Ports `turbodiffusion_tpu/ops/attention.py:38-267` and `:507-517` (the
fully-fused SageSLA path at :270-504 waits for the sagesla slice). Layout is
(B, L, H, D) throughout.

  * dense_attention(q, k, v)            — kernel K4 (ops/flash_attention.py)
  * get_block_map(q, k, ...)            — smooth-k mean-pooled block scores
                                          and the top-k LUT, plain torch
  * sla_attention(q, k, v, proj_l, cfg) — kernel K3 over the LUT, plus the
                                          linear compensation branch
  * linear_attention(q, k, v)           — plain torch

The linear branch with a non-zero `proj_l` runs plain torch on the CPU only;
its kernel (`linear_attention_pallas.linear_attention_projected`) is ROADMAP
Queue B item 13, so on a CUDA tensor it raises instead of running plain
torch on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from turbodiffusion_tpu_torch.config import AttentionConfig
from turbodiffusion_tpu_torch.ops.flash_attention import (
    flash_attention, sparse_flash_attention)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mean_pool_blocks(x, blk: int):
    """(B, H, L, D) -> (B, H, ceil(L/blk), D) block means; the last block
    averages only its valid rows; the result is rounded to x.dtype
    (attention.py:53-66)."""
    B, H, L, D = x.shape
    n = _cdiv(L, blk)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n * blk - L))
    sums = xp.reshape(B, H, n, blk, D).float().sum(3)
    counts = torch.clamp(L - torch.arange(n, device=x.device) * blk,
                         max=blk).float()
    return (sums / counts[:, None]).to(x.dtype)


def get_block_map(q, k, topk_ratio: float, block_q: int, block_k: int):
    """Top-k K-block selection per Q-block (attention.py:69-92).

    q, k: (B, L, H, D). Returns (sparse_map, lut, topk): sparse_map
    (B, H, nQ, nK) int8, lut (B, H, nQ, topk) int32, topk = max(1,
    min(nK, int(topk_ratio * nK))). Ties may be ordered differently from
    `jax.lax.top_k`: compare LUT rows as sets.
    """
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    kh = kh - kh.mean(dim=-2, keepdim=True)      # smooth-k, in k's dtype
    pq = _mean_pool_blocks(qh, block_q)
    pk = _mean_pool_blocks(kh, block_k)
    score = torch.matmul(pq.float(), pk.float().transpose(-1, -2))
    nK = score.shape[-1]
    topk = max(1, min(nK, int(topk_ratio * nK)))
    lut = torch.topk(score, topk, dim=-1).indices
    sparse_map = torch.zeros(score.shape, dtype=torch.int8, device=q.device)
    sparse_map.scatter_(-1, lut, 1)
    return sparse_map, lut.to(torch.int32), topk


def _feature_map(x, kind: str):
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    if kind == "elu":
        return torch.nn.functional.elu(x) + 1.0
    if kind == "relu":
        return torch.relu(x)
    raise NotImplementedError(f"feature map {kind}")


def linear_attention(q, k, v, feature_map: str = "softmax"):
    """o_l = (phi(q) @ (phi(k)^T v)) / (1e-5 + phi(q)·sum(phi(k)))
    (attention.py:140-149). Layout (B, L, H, D)."""
    fq = _feature_map(q, feature_map).float()
    fk = _feature_map(k, feature_map)
    kv = torch.einsum("bmhd,bmhe->bhde", fk.float(), v.float())
    ksum = fk.float().sum(1)                                  # (B, H, D)
    num = torch.einsum("blhd,bhde->blhe", fq, kv)
    den = 1e-5 + torch.einsum("blhd,bhd->blh", fq, ksum)
    return (num / den[..., None]).to(q.dtype)


def dense_attention(q, k, v, scale: Optional[float] = None):
    """Dense softmax attention: kernel K4 (plain version on the CPU)."""
    return flash_attention(q, k, v, scale=scale)


def sla_attention(q, k, v, proj_l: Optional[torch.nn.Linear],
                  cfg: AttentionConfig):
    """Sparse-Linear Attention (attention.py:186-267): top-k block-sparse
    softmax (K3) plus the linear branch projected by `proj_l` (a Linear on
    the head dim, fp32 weights, applied in q's dtype)."""
    _, lut, _ = get_block_map(q, k, cfg.sla_topk, cfg.block_q, cfg.block_k)
    o_s = sparse_flash_attention(q, k, v, lut, cfg.block_q, cfg.block_k)
    if not cfg.linear_branch:
        # a zero proj_l contributes exactly zero
        return o_s
    if q.device.type != "cpu":
        raise NotImplementedError(
            "the SLA linear branch with a non-zero proj_l has no CUDA kernel "
            "yet (ROADMAP Queue B item 13, linear_attention_projected)")
    o_l = linear_attention(q, k, v, cfg.feature_map)
    w = proj_l.weight.to(q.dtype)
    b = proj_l.bias.to(q.dtype)
    o_l = torch.matmul(o_l.to(q.dtype), w.t()) + b
    return (o_s + o_l).to(q.dtype)


def attention(q, k, v, cfg: AttentionConfig, proj_l=None):
    """Backend dispatch mirroring --attention_type (attention.py:507-517)."""
    if cfg.backend == "dense":
        return dense_attention(q, k, v)
    if cfg.backend == "sla":
        return sla_attention(q, k, v, proj_l, cfg)
    if cfg.backend == "sagesla":
        raise NotImplementedError(
            "sagesla attention waits for its kernels (ROADMAP Queue B 1-10)")
    raise ValueError(f"Unknown attention backend: {cfg.backend}")
