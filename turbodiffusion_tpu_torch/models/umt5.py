"""umT5-XXL text encoder.

Ports `turbodiffusion_tpu/models/umt5.py`: `UMT5Config`, `umt5_test_config`,
`relative_position_buckets`, the encoder (`umt5_encode` :98-120 as
`UMT5Encoder.forward`), `umt5_embed_padded` (:123-128), `init_umt5_params`
(:131-172) and `tokenize` (:182-212). T5 semantics kept: RMS-style layer
norm without mean subtraction, cast to the weight dtype before scaling; no
1/sqrt(d) attention scaling; gated tanh-GELU FFN; per-layer bucketed
relative position bias. The blocks are an `nn.ModuleList`.
"""

from __future__ import annotations

import html
import math
import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class UMT5Config:
    """umt5-xxl (umt5.py:24-36)."""
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    text_len: int = 512
    dtype: torch.dtype = torch.bfloat16


def umt5_test_config(**kw) -> UMT5Config:
    base = dict(vocab_size=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                num_layers=2, text_len=16, dtype=torch.float32)
    base.update(kw)
    return UMT5Config(**base)


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position buckets, int32 (lq, lk)
    (umt5.py:46-60)."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


def _t5_layer_norm(x, w, eps: float = 1e-6):
    """T5LayerNorm (umt5.py:63-69)."""
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
    return w.to(x.dtype) * y


def _t5_gelu(x):
    """Explicit tanh GELU in fp32 (umt5.py:72-77)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                     * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


class T5Attention(nn.Module):
    """No biases, NO softmax scaling (umt5.py:80-95)."""

    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.q = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.o = nn.Linear(cfg.dim_attn, cfg.dim, **kw)

    def forward(self, x, pos_bias, mask):
        B, L, _ = x.shape
        H = self.cfg.num_heads
        Dh = self.cfg.dim_attn // H
        q = self.q(x).reshape(B, L, H, Dh).transpose(1, 2).float()
        k = self.k(x).reshape(B, L, H, Dh).transpose(1, 2).float()
        v = self.v(x).reshape(B, L, H, Dh).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) + pos_bias[None]
        if mask is not None:
            logits = torch.where(mask[:, None, None, :] > 0, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, -1)
        return self.o(o)


class T5FeedForward(nn.Module):
    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.gate = nn.Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc1 = nn.Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc2 = nn.Linear(cfg.dim_ffn, cfg.dim, **kw)

    def forward(self, h):
        return self.fc2(self.fc1(h) * _t5_gelu(self.gate(h)))


class T5Block(nn.Module):
    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.dim, device=device, dtype=cfg.dtype))
        self.attn = T5Attention(cfg, device)
        self.norm2 = nn.Parameter(torch.ones(cfg.dim, device=device, dtype=cfg.dtype))
        self.ffn = T5FeedForward(cfg, device)
        # per-layer relative position embedding (shared_pos=False)
        self.pos_embedding = nn.Parameter(torch.zeros(
            cfg.num_buckets, cfg.num_heads, device=device, dtype=torch.float32))

    def forward(self, x, buckets, mask):
        pos_bias = self.pos_embedding.float()[buckets].permute(2, 0, 1)
        x = x + self.attn(_t5_layer_norm(x, self.norm1), pos_bias, mask)
        return x + self.ffn(_t5_layer_norm(x, self.norm2))


class UMT5Encoder(nn.Module):
    """T5Encoder; `forward` ports `umt5_encode` (umt5.py:98-120)."""

    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(
            cfg.vocab_size, cfg.dim, device=device, dtype=cfg.dtype))
        self.blocks = nn.ModuleList(T5Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim, device=device, dtype=cfg.dtype))

    def forward(self, ids, mask):
        """ids, mask: (B, L) int. Returns (B, L, dim) in cfg.dtype."""
        x = self.token_embedding[ids]
        L = ids.shape[1]
        buckets = torch.from_numpy(relative_position_buckets(
            L, L, self.cfg.num_buckets, self.cfg.max_dist)).long().to(ids.device)
        for blk in self.blocks:
            x = blk(x, buckets, mask)
        return _t5_layer_norm(x, self.norm)


def umt5_embed_padded(encoder: UMT5Encoder, ids, mask):
    """Encode, then zero positions past each sequence's length, keeping the
    fixed text_len (umt5.py:123-128)."""
    ctx = encoder(ids, mask)
    return ctx * (mask[:, :, None] > 0).to(ctx.dtype)


@torch.no_grad()
def init_umt5_params(cfg: UMT5Config, seed: int = 7, device="cpu") -> UMT5Encoder:
    """Random init per the reference's schemes (umt5.py:131-172), drawn from
    a torch.Generator seeded with `seed` on `device`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    enc = UMT5Encoder(cfg, device)
    D, Da, Df, H, nb = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads, \
        cfg.num_buckets

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=g, device=device) * std)

    for blk in enc.blocks:
        a, f = blk.attn, blk.ffn
        normal_(a.q.weight, (D * Da) ** -0.5)
        normal_(a.k.weight, D ** -0.5)
        normal_(a.v.weight, D ** -0.5)
        normal_(a.o.weight, Da ** -0.5)
        normal_(blk.pos_embedding, (2 * nb * H) ** -0.5)
        normal_(f.gate.weight, D ** -0.5)
        normal_(f.fc1.weight, D ** -0.5)
        normal_(f.fc2.weight, Df ** -0.5)
    # the 1B-entry embedding is drawn in row slabs to bound the fp32 staging
    rows = max(1, (1 << 26) // D)
    for r0 in range(0, cfg.vocab_size, rows):
        normal_(enc.token_embedding[r0:r0 + rows], 1.0)
    return enc


def tokenize(prompts, text_len: int = 512,
             tokenizer_path: Optional[str] = None):
    """HF tokenization with whitespace cleaning (umt5.py:182-212), from a
    local directory of umT5 tokenizer files only. Returns int64 (ids, mask),
    (B, L). Raises OSError when no such directory is given, ImportError
    without transformers."""
    if tokenizer_path is None or not os.path.isdir(tokenizer_path):
        raise OSError(f"no local umT5 tokenizer directory: {tokenizer_path!r}")
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(tokenizer_path, local_files_only=True)
    if isinstance(prompts, str):
        prompts = [prompts]

    def clean(text):
        try:
            import ftfy
            text = ftfy.fix_text(text)
        except ImportError:
            pass
        text = html.unescape(html.unescape(text))
        return re.sub(r"\s+", " ", text).strip()

    enc = tok([clean(p) for p in prompts], padding="max_length",
              truncation=True, max_length=text_len, return_tensors="np")
    return (torch.from_numpy(enc["input_ids"].astype(np.int64)),
            torch.from_numpy(enc["attention_mask"].astype(np.int64)))
