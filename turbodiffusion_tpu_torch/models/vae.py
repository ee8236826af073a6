"""Wan 3D causal VAE — the decode path.

Ports `turbodiffusion_tpu/models/vae.py`: the residual block, attention
block and upsamples (:259-335), `decoder_apply` (:342-360), `_vae_decode`
(:417-448) and the decoder part of `init_vae_params` (:494-592).

This ports the math, not the TPU workarounds: a 3D conv is `F.conv3d` in
(B, C, T, H, W) layout (no per-tap 2D convs, no channels-last relayout, no
128-lane channel padding). Kept, because it is the math: the chunked causal
cache — each causal conv sees [2 cached frames, chunk]; latent frame 0
bypasses the temporal upsample, so T_pixel = 1 + 4*(T_latent - 1). Module
and parameter names follow the JAX parameter tree (weights in torch layout
in both). Encode waits for I2V.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CACHE_T = 2

# Per-channel latent normalisation constants (vae.py:40-48)
LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


@dataclass(frozen=True)
class VAEConfig:
    """_video_vae defaults (vae.py:51-72)."""
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.bfloat16

    @property
    def temporal_upsample(self) -> Tuple[bool, ...]:
        return self.temporal_downsample[::-1]


class _CacheIO:
    """Construction-order cache registry (vae.py:200-222): each stateful op
    takes the next key; the first chunk starts from zeros."""

    def __init__(self, cache: Optional[Dict[str, torch.Tensor]], first: bool):
        self.cache = {} if cache is None else dict(cache)
        self.first = first
        self.counter = 0

    def pull(self, frames: int, like: torch.Tensor):
        key = f"c{self.counter}"
        self.counter += 1
        if self.first:
            B, C, _, H, W = like.shape
            return key, like.new_zeros((B, C, frames, H, W))
        return key, self.cache[key]

    def push(self, key, val):
        self.cache[key] = val


class RMSNormC(nn.Module):
    """VAE RMS_norm (vae.py:190-197): F.normalize over channels times
    sqrt(C) times gamma, in fp32."""

    def __init__(self, gamma_shape, dtype, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(gamma_shape, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        y = xf / xf.norm(dim=1, keepdim=True).clamp_min(1e-12) * (x.shape[1] ** 0.5)
        g = self.gamma.float().reshape(1, -1, *([1] * (x.dim() - 2)))
        return (y * g).to(x.dtype)


def _causal_conv3d(conv: nn.Conv3d, x, io: _CacheIO, norm: Optional[RMSNormC] = None,
                   residual=None):
    """CausalConv3d with the 2-frame cache (vae.py:243-256); `norm` applies
    the ResidualBlock's RMS norm + SiLU to [cache, x] (the cache holds raw
    frames; the norm is per frame, so this equals normalising first)."""
    x_in = x
    if conv.weight.shape[2] > 1:
        key, cache = io.pull(CACHE_T, x)
        x_in = torch.cat([cache, x], dim=2)
        io.push(key, x_in[:, :, -CACHE_T:])
    if norm is not None:
        x_in = F.silu(norm(x_in))
    kh, kw = conv.weight.shape[3:]
    out = F.conv3d(x_in, conv.weight, conv.bias, padding=(0, kh // 2, kw // 2))
    return out if residual is None else out + residual


def _conv2d_frames(conv: nn.Conv2d, x):
    """A 2D conv applied to every frame of (B, C, T, H, W), 'same' padding."""
    kh, kw = conv.weight.shape[2:]
    return F.conv3d(x, conv.weight.unsqueeze(2), conv.bias,
                    padding=(0, kh // 2, kw // 2))


class ResidualBlock(nn.Module):
    """RMS->SiLU->conv -> RMS->SiLU->conv + shortcut (vae.py:259-268)."""

    def __init__(self, c_in: int, c_out: int, dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNormC((c_in, 1, 1, 1), dtype, device)
        self.conv1 = nn.Conv3d(c_in, c_out, 3, **kw)
        self.norm2 = RMSNormC((c_out, 1, 1, 1), dtype, device)
        self.conv2 = nn.Conv3d(c_out, c_out, 3, **kw)
        self.shortcut = nn.Conv3d(c_in, c_out, 1, **kw) if c_in != c_out else None

    def forward(self, x, io: _CacheIO):
        h = _causal_conv3d(self.conv1, x, io, norm=self.norm1)
        short = x if self.shortcut is None else self.shortcut(x)
        return _causal_conv3d(self.conv2, h, io, norm=self.norm2, residual=short)


class AttentionBlock(nn.Module):
    """Single-head per-frame spatial attention (vae.py:271-283)."""

    def __init__(self, c: int, dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = RMSNormC((c, 1, 1), dtype, device)
        self.to_qkv = nn.Conv2d(c, 3 * c, 1, **kw)
        self.proj = nn.Conv2d(c, c, 1, **kw)

    def forward(self, x, io: _CacheIO = None):
        B, C, T, H, W = x.shape
        qkv = _conv2d_frames(self.to_qkv, self.norm(x))          # (B,3C,T,H,W)
        qkv = qkv.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, 3 * C)
        q, k, v = qkv.split(C, dim=-1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (C ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        return x + _conv2d_frames(self.proj, o)


class Upsample(nn.Module):
    """Resample upsample2d / upsample3d (vae.py:286-319): optional temporal
    doubling by a 2C-channel causal conv (skipped on the first chunk), then
    nearest 2x + a 3x3 conv to C/2 channels."""

    def __init__(self, c: int, temporal: bool, dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = nn.Conv2d(c, c // 2, 3, **kw)
        self.time_conv = nn.Conv3d(c, 2 * c, (3, 1, 1), **kw) if temporal else None

    def forward(self, x, io: _CacheIO):
        if self.time_conv is not None:
            B, C, T, H, W = x.shape
            key, cache = io.pull(CACHE_T, x)
            if not io.first:
                x_in = torch.cat([cache, x], dim=2)
                io.push(key, x_in[:, :, -CACHE_T:])
                y = F.conv3d(x_in, self.time_conv.weight, self.time_conv.bias)
                x = y.reshape(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5) \
                    .reshape(B, C, 2 * T, H, W)
            else:
                # frame 0 is excluded from the time_conv stream
                io.push(key, cache)
        h = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return _conv2d_frames(self.conv, h)


class Decoder3d(nn.Module):
    """Decoder3d; `forward` ports `decoder_apply` (vae.py:342-360)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        d, z = cfg.dim, cfg.z_dim
        ddims = [d * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
        self.conv1 = nn.Conv3d(z, ddims[0], 3, device=device, dtype=dt)
        self.middle = nn.ModuleList([
            ResidualBlock(ddims[0], ddims[0], dt, device),
            AttentionBlock(ddims[0], dt, device),
            ResidualBlock(ddims[0], ddims[0], dt, device)])
        layers = []
        for i, (c_in, c_out) in enumerate(zip(ddims[:-1], ddims[1:])):
            if i in (1, 2, 3):
                c_in = c_in // 2
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(c_in, c_out, dt, device))
                c_in = c_out
            if i != len(cfg.dim_mult) - 1:
                layers.append(Upsample(c_out, cfg.temporal_upsample[i], dt, device))
        self.upsamples = nn.ModuleList(layers)
        self.head_norm = RMSNormC((ddims[-1], 1, 1, 1), dt, device)
        self.head_conv = nn.Conv3d(ddims[-1], 3, 3, device=device, dtype=dt)

    def forward(self, x, cache: Optional[Dict], first: bool):
        io = _CacheIO(cache, first)
        h = _causal_conv3d(self.conv1, x, io)
        for layer in (*self.middle, *self.upsamples):
            h = layer(h, io)
        h = _causal_conv3d(self.head_conv, h, io, norm=self.head_norm)
        return h, io.cache


class WanVAE(nn.Module):
    """The decode half of WanVAE_: `conv2` (1x1x1, z -> z) and the decoder."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder3d(cfg, device)
        self.conv2 = nn.Conv3d(cfg.z_dim, cfg.z_dim, 1, device=device, dtype=cfg.dtype)


@torch.no_grad()
def vae_decode(vae: WanVAE, z, chunk: int = 1):
    """Normalised latent (B, 16, T_lat, h, w) -> video (B, 3, 1+4*(T_lat-1),
    8h, 8w) in [-1, 1], fp32 (vae.py:417-448): latent frame 0 alone, then
    `chunk` latent frames per step, threading the causal cache."""
    dev = z.device
    mean = torch.tensor(LATENT_MEAN, device=dev).reshape(1, -1, 1, 1, 1)
    std = torch.tensor(LATENT_STD, device=dev).reshape(1, -1, 1, 1, 1)
    x = (z.float() * std + mean).to(vae.cfg.dtype)
    x = vae.conv2(x)
    out0, cache = vae.decoder(x[:, :, :1], None, first=True)
    rest = x[:, :, 1:]
    T_rest = rest.shape[2]
    if T_rest % chunk:
        raise ValueError(f"T_lat-1={T_rest} must be divisible by chunk={chunk}")
    outs = [out0]
    for t0 in range(0, T_rest, chunk):
        out, cache = vae.decoder(rest[:, :, t0:t0 + chunk], cache, first=False)
        outs.append(out)
    return torch.cat(outs, dim=2).float()


@torch.no_grad()
def init_vae_params(cfg: VAEConfig = VAEConfig(), seed: int = 3,
                    device="cuda") -> WanVAE:
    """Random decoder params with the reference topology (vae.py:494-592):
    conv weights N(0, 1/fan_in), zero biases, unit gammas, drawn from a
    torch.Generator seeded with `seed` on `device`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    vae = WanVAE(cfg, device)
    for m in vae.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = int(np.prod(m.weight.shape[1:]))
            m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=device)
                           / np.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, RMSNormC):
            m.gamma.fill_(1.0)
    return vae
