"""Wan2.1 video diffusion transformer (T2V).

Ports `turbodiffusion_tpu/models/wan.py`:
  * `WanSelfAttention`   ← `_self_attention`: the fused SageSLA branch
    (:97-151, without Ulysses) and the composable path (:153-169), each with
    separate q/k/v linears or the fused `qkv` one
  * `WanCrossAttention`  ← `_cross_attention` (:183-226, text-only)
  * `WanFFN`             ← `_ffn`: the int8 hidden chain (:248-268) and the
    fallback (:283-284)
  * `WanAttentionBlock`  ← `wan_block` (:287-335)
  * `WanHead`            ← `wan_head` (:338-345)
  * `patchify` / `unpatchify` (:374-384)
  * `WanModel.forward`   ← `wan_forward` (:387-467); the blocks are an
    `nn.ModuleList` run by a Python loop where JAX scans stacked params
  * `init_wan_params`    (:474-575)

Every linear of a block goes through `ops/quant.linear_maybe_quant`: bf16
`nn.Linear`s; W8A8 `Int8BlockLinear`s with 128x128 block scales (the
reference's quantised checkpoints, K22 each), which keep the bf16
composition of the block (JAX's `scale.ndim == 1` tests, wan.py:139, :192,
:248-249, :301, :317, :331: every `isinstance(..., Int8Linear)` below is
False for them); or, after `ops/quant.quantize_wan_blocks`
(`--quant_linear`), W8A8 postscale `Int8Linear`s. With postscale linears
the block takes JAX's int8 feeds
(`_prequantized` / `_lin_q`, wan.py:68-78, 296-334): the quant-out LN (K12)
feeds the QKV, cross-Q and fc1 GEMMs, `unfold_quant` (K13; K16 above
H*Dh 4096) the fused path's O projection and `cross_attention_qout` (K14;
K15 + K17 above H*Dh 2048) the cross O projection, each an (int8, per-row
fp32 scale) pair consumed by `int8_linear_prequant`; the FFN's int8 hidden
runs K10 -> K11 (BN 896 at 1.3B, 768 at 14B). JAX takes
these branches on the TPU only; the port takes them on every device (the
CPU runs the kernels' plain versions). Left out with the paths they serve:
the FFN half-split and its `L*n_ffn` guard (16 GB-chip memory guards),
the selective remat modes, sharding constraints and Ulysses (multi-GPU)
and `_img_emb` (I2V).

Training: the bf16 `dense` / `sla` forward carries gradients to every
parameter (K1-K4 and K21 run inside autograd Functions; K3's backward is
K23 + K24). `cfg.remat` "block_wise" / "full" wraps each block in
`torch.utils.checkpoint` (wan.py:436-456, nothing saveable): the backward
recomputes the block, launching each of its forward kernels a second time,
with the same LUT (top-k and the kernels are deterministic).

fp32 islands as in JAX: time embedding and projection, AdaLN modulation and
the head run in fp32; the trunk runs in `cfg.dtype`. The fused norms (K1,
K2, K12), attention (K3, K4, K14, K17; K20 for sagesla at blocks < 128),
the fused SageSLA path (K5-K7 at v_quant "channel", K5 + K18 + K19 at
"row"; K13, K15, K16), the SLA linear branch (K21) and the W8A8 linears
(K8-K11) dispatch to the CUDA kernels on the card. Wide models (Wan2.1-14B: dim 5120) keep Q, K and V as three
linears (`quantize_wan_blocks(fuse_qkv=False)`, as JAX fuses below 4096).

The forward-mode pass (`jvp_mode(model)`: cfg.attention.jvp_mode, the sCM
tangent of rCM distillation) takes JAX's routes (wan.py:56, :155-158, :194,
:213-224, :302-334): the plain norms (`force_ref`) in place of K1 / K2, no
fused sagesla, no int8 feed and no cross qout, and attention through the
forward-mode wrappers whose tangent rules are K25 / K26; the caller runs it
under `torch.autograd.forward_ad` and `torch.no_grad()`, so no block is
rematerialised.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn
from torch.utils.checkpoint import checkpoint

from turbodiffusion_tpu_torch.config import WanConfig
from turbodiffusion_tpu_torch.models.layers import (
    gelu_tanh, layer_norm, rms_norm, sinusoidal_embedding_1d)
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops.attention import (
    attention, dense_attention, fused_sla_geometry, sla_attention_fused)
from turbodiffusion_tpu_torch.ops.flash_attention import cross_attention_qout
from turbodiffusion_tpu_torch.ops.fused_norm import (
    modulated_layer_norm, rmsnorm_rope, rope_cos_sin_full)
from turbodiffusion_tpu_torch.ops.quant import (
    Int8Linear, int8_gemm_blockact, int8_gemm_postscale_qout,
    int8_linear_prequant, linear_maybe_quant, pick_bn_div, quantize_rows_int8)
from turbodiffusion_tpu_torch.ops.sla_fused import unfold_planes, unfold_quant


def _prequantized(x) -> bool:
    """x may be an (int8, row scale) pair from an int8 feed (wan.py:68-70)."""
    return isinstance(x, tuple)


def _lin_q(lin, x, act=None):
    """A linear over a maybe-prequantised activation (wan.py:73-78)."""
    if _prequantized(x):
        return int8_linear_prequant(x[0], x[1], lin, act=act)
    return linear_maybe_quant(lin, x, act=act)


class WanSelfAttention(nn.Module):
    """QKV + RMSNorm-QK + RoPE (K2) + attention (K3, K4, or K20 for sagesla
    at blocks < 128; K21 for a non-zero proj_l) + O; in the fused SageSLA
    geometry, QKV + `sla_attention_fused` (K5-K7, or K5 + K18 + K19 (+ K21)
    at v_quant "row") + unfold + O,
    the unfold being K13's int8 feed (K16's above H*Dh 4096) when O is an
    `Int8Linear`. x may be an
    (int8, scale) pair from K12. With a fused `qkv` linear (q, k and v
    None), Q, K and V are column groups of its output, read in place by K5
    or K2 and the attention kernels."""

    def __init__(self, cfg: WanConfig, with_proj_l: bool, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.dim, cfg.dtype
        kw = dict(device=device, dtype=dt)
        self.q, self.k = nn.Linear(D, D, **kw), nn.Linear(D, D, **kw)
        self.v, self.o = nn.Linear(D, D, **kw), nn.Linear(D, D, **kw)
        self.qkv = None                    # set by quantize_wan_blocks
        self.norm_q = nn.Parameter(torch.ones(D, **kw))
        self.norm_k = nn.Parameter(torch.ones(D, **kw))
        # zero-init learned linear-branch projection (SLA/core.py:78-81)
        self.proj_l = (nn.Linear(cfg.head_dim, cfg.head_dim, device=device,
                                 dtype=torch.float32)
                       if with_proj_l else None)

    def forward(self, x, rope_cs, gate=None, residual=None):
        cfg = self.cfg
        B, Lx, D = (x[0] if _prequantized(x) else x).shape
        H, Dh = cfg.num_heads, cfg.head_dim
        cosF, sinF = rope_cs
        if self.qkv is not None:
            # one GEMM, one activation quantisation; views, no split copies
            q_proj, k_proj, v_proj = _lin_q(self.qkv, x).split(D, -1)
        else:
            q_proj, k_proj, v_proj = (_lin_q(lin, x)
                                      for lin in (self.q, self.k, self.v))
        if fused_sla_geometry(cfg.attention, Dh):
            planes = sla_attention_fused(
                q_proj, k_proj, v_proj, self.norm_q, self.norm_k, rope_cs,
                self.proj_l, cfg.attention, num_heads=H, eps=cfg.eps)
            if isinstance(self.o, Int8Linear):
                xq, rs = unfold_quant(planes, Lx)
                return int8_linear_prequant(xq, rs, self.o, gate=gate,
                                            residual=residual)
            return linear_maybe_quant(self.o,
                                      unfold_planes(planes, Lx).to(cfg.dtype),
                                      gate=gate, residual=residual)
        ref = cfg.attention.jvp_mode
        q = rmsnorm_rope(q_proj, self.norm_q, cosF, sinF, num_heads=H,
                         eps=cfg.eps, force_ref=ref)
        k = rmsnorm_rope(k_proj, self.norm_k, cosF, sinF, num_heads=H,
                         eps=cfg.eps, force_ref=ref)
        v = v_proj.reshape(B, Lx, H, Dh)
        o = attention(q, k, v, cfg.attention, proj_l=self.proj_l)
        return linear_maybe_quant(self.o, o.reshape(B, Lx, D), gate=gate,
                                  residual=residual)


class WanCrossAttention(nn.Module):
    """Text cross-attention: q-RMSNorm (K2, no RoPE) + dense attention (K4)
    over the text tokens; with an `Int8Linear` O and heads of 128, K14 does
    the q-RMSNorm, the attention and the int8 O feed in one launch
    (wan.py:192-210), K15 + K17 above H*Dh 2048 (the 14B's 40 heads). x may
    be an (int8, scale) pair from K12. The K/V side
    is plain torch around its linears, as in JAX."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.dim, cfg.dtype
        kw = dict(device=device, dtype=dt)
        self.q, self.k = nn.Linear(D, D, **kw), nn.Linear(D, D, **kw)
        self.v, self.o = nn.Linear(D, D, **kw), nn.Linear(D, D, **kw)
        self.norm_q = nn.Parameter(torch.ones(D, **kw))
        self.norm_k = nn.Parameter(torch.ones(D, **kw))

    def forward(self, x, context, residual=None):
        cfg = self.cfg
        B, Lx, D = (x[0] if _prequantized(x) else x).shape
        H, Dh = cfg.num_heads, cfg.head_dim
        q_proj = _lin_q(self.q, x)
        k = rms_norm(linear_maybe_quant(self.k, context), self.norm_k,
                     eps=cfg.eps)
        k = k.reshape(B, -1, H, Dh)
        v = linear_maybe_quant(self.v, context).reshape(B, -1, H, Dh)
        jvp = cfg.attention.jvp_mode
        if isinstance(self.o, Int8Linear) and Dh % 128 == 0 and not jvp:
            xq, rs = cross_attention_qout(q_proj, k, v, self.norm_q,
                                          eps=cfg.eps)
            return int8_linear_prequant(xq, rs, self.o, residual=residual)
        q = rmsnorm_rope(q_proj, self.norm_q, num_heads=H, eps=cfg.eps,
                         force_ref=jvp)
        o = dense_attention(q, k, v, jvp_mode=jvp)
        return linear_maybe_quant(self.o, o.reshape(B, Lx, D),
                                  residual=residual)


class WanFFN(nn.Module):
    """Linear -> GELU(tanh) -> Linear, gated residual (wan.py:243-284).

    x may be an (int8, scale) pair from K12. W8A8 at batch 1, when ffn_dim
    has a block divisor (`pick_bn_div`, 896 at 1.3B): the pair (or K8's of a
    bf16 x) feeds K10, which runs fc1 with the GELU and emits the hidden as
    int8 with per-(row, BN) scales, and K11 runs fc2 rescaling per BN-wide
    K slab with the gate and residual fused; the hidden never exists in
    bf16. Otherwise fc1 takes the pair (or quantises x itself) and fc2
    quantises its input."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.dtype = cfg.dtype
        self.fc1 = nn.Linear(cfg.dim, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.dim, **kw)

    def forward(self, x, gate=None, residual=None):
        fc1, fc2 = self.fc1, self.fc2
        B, L, D = (x[0] if _prequantized(x) else x).shape
        bn = pick_bn_div(fc1.out_features)
        if (isinstance(fc1, Int8Linear) and isinstance(fc2, Int8Linear)
                and B == 1 and bn):
            xq, rs = (x if _prequantized(x)
                      else quantize_rows_int8(x.reshape(L, D)))
            hq, hs = int8_gemm_postscale_qout(
                xq.reshape(L, D), rs.reshape(L, 1), fc1.w_int8, fc1.scale,
                fc1.bias, act="gelu_tanh")
            y = int8_gemm_blockact(
                hq, hs, fc2.w_int8, fc2.scale, fc2.bias, bk=bn,
                gate=None if gate is None else gate.reshape(-1),
                residual=None if residual is None else residual.reshape(L, -1),
                out_dtype=self.dtype)
            return y.reshape(B, L, -1)
        return linear_maybe_quant(fc2, _lin_q(fc1, x, act="gelu_tanh"),
                                  gate=gate, residual=residual)


class WanAttentionBlock(nn.Module):
    """WanAttentionBlock (wan.py:287-335): norm1 + AdaLN (K1) -> self-attn
    -> norm3 (K1, affine) -> cross-attn -> norm2 + AdaLN (K1) -> FFN. Each
    norm whose consumer GEMM is an `Int8Linear` emits int8 instead (K12):
    norm1 when the QKV linear is, norm3 when the cross Q linear is too,
    norm2 when fc1 is (wan.py:296-334)."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        use_sla = cfg.attention.backend in ("sla", "sagesla")
        kw = dict(device=device, dtype=cfg.dtype)
        self.self_attn = WanSelfAttention(cfg, use_sla, device)
        self.cross_attn = WanCrossAttention(cfg, device)
        self.ffn = WanFFN(cfg, device)
        self.modulation = nn.Parameter(torch.zeros(6, cfg.dim, **kw))
        if cfg.cross_attn_norm:
            self.norm3_weight = nn.Parameter(torch.ones(cfg.dim, **kw))
            self.norm3_bias = nn.Parameter(torch.zeros(cfg.dim, **kw))

    def forward(self, x, e0_B6D, rope_cs, context):
        eps = self.cfg.eps
        ref = self.cfg.attention.jvp_mode
        e = self.modulation.float()[None] + e0_B6D          # (B, 6, D) fp32
        e0, e1, e2, e3, e4, e5 = [e[:, i:i + 1] for i in range(6)]
        sa = self.self_attn
        qout = (isinstance(sa.qkv if sa.qkv is not None else sa.q, Int8Linear)
                and not ref)
        x = sa(modulated_layer_norm(x, e1, e0, eps=eps, quant_out=qout,
                                    force_ref=ref),
               rope_cs, gate=e2, residual=x)
        n3 = x
        if self.cfg.cross_attn_norm:
            n3 = modulated_layer_norm(
                x, weight=self.norm3_weight, bias=self.norm3_bias, eps=eps,
                quant_out=qout and isinstance(self.cross_attn.q, Int8Linear),
                force_ref=ref)
        x = self.cross_attn(n3, context, residual=x)
        qout_ffn = qout and isinstance(self.ffn.fc1, Int8Linear)
        return self.ffn(modulated_layer_norm(x, e4, e3, eps=eps,
                                             quant_out=qout_ffn,
                                             force_ref=ref),
                        gate=e5, residual=x)


class WanHead(nn.Module):
    """Modulated output projection in fp32 (wan.py:338-345)."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.eps = cfg.eps
        out = cfg.out_dim * math.prod(cfg.patch_size)
        self.head = nn.Linear(cfg.dim, out, device=device, dtype=torch.float32)
        self.modulation = nn.Parameter(
            torch.zeros(2, cfg.dim, device=device, dtype=torch.float32))

    def forward(self, x, e_B_D):
        e = self.modulation.float()[None] + e_B_D[:, None]   # (B, 2, D)
        e0, e1 = e[:, 0:1], e[:, 1:2]
        n = layer_norm(x, eps=self.eps).float()
        return self.head(n * (1 + e1) + e0)


def patchify(x_BCTHW, patch_size):
    """(B,C,T,H,W) -> (B, T*H/kh*W/kw, C*kt*kh*kw) (wan.py:374-378)."""
    kt, kh, kw = patch_size
    return rearrange(x_BCTHW, "b c (t kt) (h kh) (w kw) -> b (t h w) (c kt kh kw)",
                     kt=kt, kh=kh, kw=kw)


def unpatchify(x_BLD, T, H, W, patch_size, out_dim):
    """Inverse of `patchify` for the head output (wan.py:381-384)."""
    kt, kh, kw = patch_size
    return rearrange(x_BLD, "b (t h w) (kt kh kw d) -> b d (t kt) (h kh) (w kw)",
                     t=T, h=H, w=W, kt=kt, kh=kh, kw=kw, d=out_dim)


class WanModel(nn.Module):
    """The Wan DiT; `forward` ports `wan_forward` (wan.py:387-467)."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        kw = dict(device=device, dtype=cfg.dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.patch_embedding = nn.Linear(cfg.in_dim * math.prod(cfg.patch_size),
                                         D, **kw)
        self.text_embedding = nn.ModuleDict({
            "fc1": nn.Linear(cfg.text_dim, D, **kw),
            "fc2": nn.Linear(D, D, **kw)})
        self.time_embedding = nn.ModuleDict({
            "fc1": nn.Linear(cfg.freq_dim, D, **f32),
            "fc2": nn.Linear(D, D, **f32)})
        self.time_projection = nn.ModuleDict({"fc": nn.Linear(D, 6 * D, **f32)})
        self.blocks = nn.ModuleList(WanAttentionBlock(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.head = WanHead(cfg, device)

    def forward(self, x_B_C_T_H_W, timesteps_B_T, crossattn_emb):
        """x: noisy latent (B, C, T, H, W); timesteps (B, 1) in [0, 1000];
        crossattn_emb: umT5 embedding (B, text_len, text_dim). Returns the
        fp32 velocity (B, out_dim, T, H, W)."""
        cfg = self.cfg
        t_B = timesteps_B_T[:, 0]
        kt, kh, kw = cfg.patch_size
        B, _, T_in, H_in, W_in = x_B_C_T_H_W.shape
        T, H, W = T_in // kt, H_in // kh, W_in // kw

        x = self.patch_embedding(patchify(x_B_C_T_H_W.to(cfg.dtype),
                                          cfg.patch_size))
        te = self.time_embedding
        emb = sinusoidal_embedding_1d(cfg.freq_dim, t_B)
        e_B_D = te["fc2"](F.silu(te["fc1"](emb)))
        e0_B6D = self.time_projection["fc"](F.silu(e_B_D)).reshape(B, 6, cfg.dim)
        txt = self.text_embedding
        context = txt["fc2"](gelu_tanh(txt["fc1"](crossattn_emb.to(cfg.dtype))))
        rope_cs = rope_cos_sin_full(rope_freqs_3d(T, H, W, cfg.head_dim,
                                                  device=x.device))
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(blk, x, e0_B6D, rope_cs, context,
                               use_reentrant=False)
            else:
                x = blk(x, e0_B6D, rope_cs, context)
        out = self.head(x, e_B_D)
        return unpatchify(out, T, H, W, cfg.patch_size, cfg.out_dim)


@contextlib.contextmanager
def jvp_mode(model: nn.Module):
    """Run `model` in the forward-mode pass: every module's config takes
    attention.jvp_mode (JAX's `jvp_cfg`, distill.py:90-91) until the block
    exits, when each gets its own config back."""
    saved = [(m, m.cfg) for m in model.modules() if hasattr(m, "cfg")]
    try:
        for m, cfg in saved:
            m.cfg = cfg.replace(attention=dataclasses.replace(
                cfg.attention, jvp_mode=True))
        yield model
    finally:
        for m, cfg in saved:
            m.cfg = cfg


# ---------------------------------------------------------------------------
# random init (wan.py:474-575)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std, g, device):
    """Normal truncated to [-2, 2] then scaled by std, drawn by inverse CDF
    (jax.random.truncated_normal(-2, 2) * std)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.empty(shape, device=device).uniform_(lo, 1 - lo, generator=g)
    return torch.erfinv(2 * u - 1) * (math.sqrt(2) * std)


@torch.no_grad()
def _init_linear(lin: nn.Linear, g, std: Optional[float] = None,
                 zero: bool = False):
    fan_out, fan_in = lin.weight.shape
    dev = lin.weight.device
    if zero:
        lin.weight.zero_()
    elif std is not None:
        lin.weight.copy_(_trunc_normal((fan_out, fan_in), std, g, dev))
    else:                                   # xavier uniform
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        lin.weight.copy_(torch.empty((fan_out, fan_in), device=dev)
                         .uniform_(-limit, limit, generator=g))
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def init_wan_params(cfg: WanConfig, seed: int = 0, device="cuda") -> WanModel:
    """A WanModel with the reference's random init (trunc-normal attention
    weights std 1/sqrt(dim), xavier FFN, zero head, zero proj_l), drawn from
    a torch.Generator seeded with `seed` on `device`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    model = WanModel(cfg, device)
    std = 1.0 / math.sqrt(cfg.dim)
    for blk in model.blocks:
        for attn in (blk.self_attn, blk.cross_attn):
            for lin in (attn.q, attn.k, attn.v, attn.o):
                _init_linear(lin, g, std=std)
            attn.norm_q.fill_(1.0)
            attn.norm_k.fill_(1.0)
        if blk.self_attn.proj_l is not None:
            _init_linear(blk.self_attn.proj_l, g, zero=True)
        _init_linear(blk.ffn.fc1, g)
        _init_linear(blk.ffn.fc2, g)
        blk.modulation.copy_(_trunc_normal(blk.modulation.shape, std, g, device))
        if cfg.cross_attn_norm:
            blk.norm3_weight.fill_(1.0)
            blk.norm3_bias.zero_()
    _init_linear(model.patch_embedding, g)
    for lin in (model.text_embedding["fc1"], model.text_embedding["fc2"],
                model.time_embedding["fc1"], model.time_embedding["fc2"],
                model.time_projection["fc"]):
        _init_linear(lin, g, std=0.02)
    _init_linear(model.head.head, g, zero=True)
    model.head.modulation.copy_(_trunc_normal((2, cfg.dim), std, g, device))
    return model
