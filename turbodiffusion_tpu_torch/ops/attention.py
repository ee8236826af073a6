"""Attention backends: dense, SLA and SageSLA (sparse-linear attention).

Ports `turbodiffusion_tpu/ops/attention.py:38-267`, `:336-504` and
`:507-517`. Layout is (B, L, H, D), except the fused path's head planes.

  * dense_attention(q, k, v)            — kernel K4 (ops/flash_attention.py)
  * get_block_map(q, k, ...)            — smooth-k mean-pooled block scores
                                          and the top-k LUT, plain torch
  * sla_attention(q, k, v, proj_l, cfg) — kernel K3 (int8_qk: K20) over
                                          the LUT, plus the linear
                                          compensation branch (K21)
  * linear_attention(q, k, v)           — plain torch (feature maps other
                                          than softmax, which JAX runs in
                                          jnp on every device)
  * sla_attention_fused(q_proj, ...)    — SageSLA from the raw projections:
                                          kernels K5, then K6 + K7
                                          (v_quant "channel") or K18 + K19
                                          (+ K21 with the linear branch;
                                          v_quant "row"); K15 above H*Dh
                                          4096
  * attention(q, k, v, cfg)             — backend dispatch; sagesla outside
                                          the fused geometry at blocks
                                          < 128 runs K20
  * cfg.jvp_mode (the sCM tangent pass)  — dense attention through
                                          `flash_attention_jvp` (tangent
                                          rule K25), sla and sagesla through
                                          `sparse_attention_jvp` (K26) plus
                                          the plain-torch linear branch
                                          (attention.py:161-179, :230-243)

Gradients: `dense_attention` and `sla_attention` without int8 QK carry them
to q, k, v and `proj_l` (K3, K4 and K21 run inside autograd Functions; K3's
backward is K23 + K24), as JAX's custom VJPs do; the fused and int8 paths
are inference-only, as in JAX.

SageSLA outside the fused geometry takes JAX's TPU composition on every
device: at blocks < 128 the int8-QK gather (K20, its plain version on the
CPU). At blocks >= 128 it is reached only by a head dim that is no
multiple of 128 (LTX-2): there the CPU runs K3's plain version as JAX does
off the TPU, and a CUDA tensor raises (ROADMAP Queue A item 13).
"""

from __future__ import annotations

from typing import Optional

import torch

from turbodiffusion_tpu_torch.config import AttentionConfig
from turbodiffusion_tpu_torch.ops.flash_attention import (
    flash_attention, sparse_flash_attention, sparse_flash_attention_i8qk)
from turbodiffusion_tpu_torch.ops.flash_jvp import (
    flash_attention_jvp, sparse_attention_jvp)
from turbodiffusion_tpu_torch.ops.linear_attention import (
    linear_attention_projected, linear_projected_planes)
from turbodiffusion_tpu_torch.ops.sla_fused import (
    block_map_from_pooled, head_planes, row_rms_inv, subquant_pack_kv,
    subquant_pack_kvt)
from turbodiffusion_tpu_torch.ops.sparse_i8_attention import (
    quantize_v_per_channel, sparse_attention_i8_planes,
    sparse_attention_i8_vt)


# widest projection row K5 reduces itself; wider ones take K15's statistic
_WIDE_HD = 4096


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
    `jax.lax.top_k`: compare LUT rows as sets. Not differentiable: the LUT
    is integer, as in JAX.
    """
    qh = q.detach().transpose(1, 2)
    kh = k.detach().transpose(1, 2)
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


def dense_attention(q, k, v, scale: Optional[float] = None,
                    jvp_mode: bool = False):
    """Dense softmax attention: kernel K4 (plain version on the CPU);
    jvp_mode: the forward-mode wrapper, whose tangent rule is K25."""
    if jvp_mode:
        return flash_attention_jvp(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


def _projected(o_l, proj_l, dtype):
    """proj_l applied to the linear branch in `dtype` (JAX's jnp chain)."""
    w, b = proj_l.weight.to(dtype), proj_l.bias.to(dtype)
    return torch.matmul(o_l.to(dtype), w.t()) + b


def sla_attention(q, k, v, proj_l: Optional[torch.nn.Linear],
                  cfg: AttentionConfig, int8_qk: bool = False):
    """Sparse-Linear Attention (attention.py:186-267): top-k block-sparse
    softmax, K3 (int8_qk: smooth-k and the int8-QK gather K20, composable
    SageSLA at blocks < 128), plus the linear branch projected by `proj_l`
    (a Linear on the head dim, fp32 weights): the softmax feature map
    through K21 (`linear_attention_projected`, the TPU's kernel), any other
    in plain torch (JAX's jnp chain, proj_l applied in q's dtype).

    cfg.jvp_mode (attention.py:230-243): the forward-mode wrapper over the
    same LUT (taken from the primal q and k; its tangent rule is K26) and
    the linear branch as the jnp chain, which K21 has no tangent rule for;
    int8 QK is off, as quantisation is in JAX's tangent pass."""
    _, lut, _ = get_block_map(q, k, cfg.sla_topk, cfg.block_q, cfg.block_k)
    if cfg.jvp_mode:
        o_s = sparse_attention_jvp(q, k, v, lut, cfg.block_q, cfg.block_k)
        if not cfg.linear_branch:
            return o_s
        o_l = linear_attention(q, k, v, cfg.feature_map)
        return (o_s + _projected(o_l, proj_l, q.dtype)).to(q.dtype)
    sparse = sparse_flash_attention_i8qk if int8_qk else sparse_flash_attention
    o_s = sparse(q, k, v, lut, cfg.block_q, cfg.block_k)
    if not cfg.linear_branch:
        # a zero proj_l contributes exactly zero
        return o_s
    if cfg.feature_map == "softmax":
        o_l = linear_attention_projected(q, k, v, proj_l.weight, proj_l.bias)
        return (o_s + o_l).to(q.dtype)
    o_l = linear_attention(q, k, v, cfg.feature_map)
    return (o_s + _projected(o_l, proj_l, q.dtype)).to(q.dtype)


def fused_sla_geometry(cfg: AttentionConfig, head_dim: int) -> bool:
    """Whether sagesla takes the fused path: `models/wan.py:_use_fused_sla`
    without its device test, so the CPU runs the same path on the kernels'
    plain versions; never in the forward-mode pass."""
    return (cfg.backend == "sagesla" and not cfg.jvp_mode
            and head_dim % 128 == 0
            and cfg.block_q >= 128 and cfg.block_k >= 128)


def sla_attention_fused(q_proj, k_proj, v_proj, norm_q_w, norm_k_w, rope_cs,
                        proj_l: Optional[torch.nn.Linear],
                        cfg: AttentionConfig, *, num_heads: int,
                        eps: float = 1e-6):
    """Fused SageSLA from the raw (B, L, H*Dh) projections
    (attention.py:336-504, single device): RMSNorm-QK, RoPE, the head fold,
    block pooling and the int8 quantisation of Q run in K5 passes; the
    block map in plain torch. Then, by `cfg.v_quant`:
      * "channel" (the VT kernel): V quantised per channel in plain torch;
        K6 packs K and V (and sums the linear branch's kv); K7 attends, with
        the linear branch in its epilogue (the TDX_LIN_FUSED=1 default);
      * "row" (attention.py:492-503): K5 gives V as int8 with per-row scales
        (and bf16 planes of Q and V when the linear branch is on, which JAX
        cannot fuse here); K18 packs K and V; K19 attends; the branch, when
        on, is K21 over the planes.
    Returns (B, H, Lp, Dh) bf16 planes, Lp = L rounded up to 512; feed
    `unfold_planes` (or `unfold_quant`) to the O projection.

    Wide models (H*Dh > 4096, the 14B's 5120; attention.py:362-396): the
    full-row RMS inverse of Q and K comes from `row_rms_inv` (K15) and K5
    reads it (its external-RMS mode), walking the heads in groups inside
    one launch a plane, where the TPU tiles head groups over launches.

    Q is pooled at block_q directly, where the TPU pools at 256 and merges
    pairs weighted by count (attention.py:413-440): the same block means.
    `TDX_SPARSE_VT` has no counterpart: "channel" always takes K7."""
    B, L, HD = q_proj.shape
    H = num_heads
    Lp = -(-L // 512) * 512
    if (not fused_sla_geometry(cfg, HD // H) or Lp % cfg.block_q
            or Lp % cfg.block_k or cfg.v_quant not in ("channel", "row")):
        raise ValueError(
            f"the fused SageSLA path takes v_quant 'channel' or 'row', "
            f"head_dim % 128 == 0 and blocks >= 128 dividing 512, got "
            f"{cfg.v_quant!r}, {HD // H}, {cfg.block_q}/{cfg.block_k}")
    cosF, sinF = rope_cs
    lin = cfg.linear_branch and proj_l is not None
    v_chan = cfg.v_quant == "channel"
    kw = dict(num_heads=H, eps=eps, pad_to=Lp)
    wide = HD > _WIDE_HD
    Q = head_planes(q_proj, norm_q_w, cosF, sinF, pool=cfg.block_q,
                    quant=True, bf16_out=lin and not v_chan,
                    rms_inv=row_rms_inv(q_proj, eps) if wide else None, **kw)
    K = head_planes(k_proj, norm_k_w, cosF, sinF, pool=cfg.block_k,
                    rms_inv=row_rms_inv(k_proj, eps) if wide else None, **kw)
    V = head_planes(v_proj, quant=not v_chan, bf16_out=lin or v_chan, **kw)
    lut, _, k_mean = block_map_from_pooled(Q["pooled"], K["pooled"], L,
                                           cfg.block_k, cfg.sla_topk)
    blocks = dict(block_q=cfg.block_q, block_k=cfg.block_k, kv_len=L)
    if not v_chan:
        kvi, ks = subquant_pack_kv(K["bf16"], k_mean, V["i8"])
        o = sparse_attention_i8_planes(Q["i8"], Q["scale"], kvi, ks,
                                       V["scale"], lut, **blocks)
        if lin:
            o = o + linear_projected_planes(Q["bf16"], K["bf16"], V["bf16"],
                                            proj_l.weight, proj_l.bias, L)
        return o
    vi, vcs = quantize_v_per_channel(V["bf16"], L)
    packed = subquant_pack_kvt(K["bf16"], k_mean, vi, cfg.block_k, kv_len=L,
                               linear_kv=lin)
    kp, vtp, ksb = packed[:3]
    lin_kvw = lin_ksb = None
    if lin:
        kv, ksum = packed[3], packed[4]
        # fold V's per-channel int8 scale into kv's columns (exact), then
        # proj_l: kvw = (kv * vcs) @ W^T, W the (out, in) Linear weight
        lin_kvw = torch.matmul(kv * vcs, proj_l.weight.float().t())
        bias = proj_l.bias.float().expand(ksum.shape)
        lin_ksb = torch.cat([ksum, bias], dim=2)              # (B, H, 2, D)
    return sparse_attention_i8_vt(
        Q["i8"], Q["scale"], kp, vtp, ksb, vcs, lut, lin_kvw=lin_kvw,
        lin_ks_bias=lin_ksb, **blocks)


def attention(q, k, v, cfg: AttentionConfig, proj_l=None):
    """Backend dispatch mirroring --attention_type (attention.py:507-517).
    sagesla here is the composable path (outside the fused geometry): at
    blocks < 128 the int8-QK gather (K20) on every device; at blocks >= 128
    (a head dim that is no multiple of 128) K3's plain version on the CPU,
    as the JAX package runs it there, and no kernel yet on a card. In
    cfg.jvp_mode every backend takes its forward-mode wrapper."""
    if cfg.backend == "dense":
        return dense_attention(q, k, v, jvp_mode=cfg.jvp_mode)
    if cfg.backend == "sla" or (cfg.backend == "sagesla" and cfg.jvp_mode):
        return sla_attention(q, k, v, proj_l, cfg)
    if cfg.backend == "sagesla":
        if min(cfg.block_q, cfg.block_k) < 128:
            return sla_attention(q, k, v, proj_l, cfg, int8_qk=True)
        if q.device.type != "cpu":
            raise NotImplementedError(
                "sagesla at blocks >= 128 outside the fused geometry (head "
                "dim % 128 != 0) needs the composable int8-QK planes path "
                "(ROADMAP Queue A item 13, LTX-2)")
        return sla_attention(q, k, v, proj_l, cfg)
    raise ValueError(f"Unknown attention backend: {cfg.backend}")
