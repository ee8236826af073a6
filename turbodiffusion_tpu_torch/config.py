"""Typed configuration for the PyTorch port.

Ports `turbodiffusion_tpu/config.py:20-201`: the resolution tables,
`AttentionConfig`, `WanConfig` (with torch dtypes), the `wan_config` presets,
`wan_test_config` and `GenerationConfig`. `MeshConfig` waits for multi-GPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import torch

# Resolution tables (config.py:20-35).
VIDEO_RES_SIZE_INFO: dict[str, dict[str, tuple[int, int]]] = {
    "720": {"1:1": (960, 960), "4:3": (960, 704), "3:4": (704, 960), "16:9": (1280, 704), "9:16": (704, 1280)},
    "512": {"1:1": (512, 512), "4:3": (640, 512), "3:4": (512, 640), "16:9": (640, 384), "9:16": (384, 640)},
    "480": {"1:1": (480, 480), "4:3": (640, 480), "3:4": (480, 640), "16:9": (768, 432), "9:16": (432, 768)},
    "480p": {"1:1": (640, 640), "4:3": (640, 480), "3:4": (480, 640), "16:9": (832, 480), "9:16": (480, 832)},
    "720p": {"1:1": (960, 960), "4:3": (960, 720), "3:4": (720, 960), "16:9": (1280, 720), "9:16": (720, 1280)},
    # smoke preset for checkpoint-free CLI runs
    "tiny": {"1:1": (64, 64), "16:9": (128, 64)},
}

IMAGE_RES_SIZE_INFO: dict[str, dict[str, tuple[int, int]]] = {
    "1024": {"1:1": (1024, 1024), "4:3": (1168, 880), "3:4": (880, 1168), "16:9": (1360, 768), "9:16": (768, 1360)},
    "720": {"1:1": (960, 960), "4:3": (960, 704), "3:4": (704, 960), "16:9": (1280, 704), "9:16": (704, 1280)},
    "512": {"1:1": (512, 512), "4:3": (640, 512), "3:4": (512, 640), "16:9": (640, 384), "9:16": (384, 640)},
    "480": {"1:1": (480, 480), "4:3": (640, 480), "3:4": (480, 640), "16:9": (768, 432), "9:16": (432, 768)},
}


@dataclass(frozen=True)
class AttentionConfig:
    """Attention backend selection (config.py:42-79).

    backend: "dense" | "sla" | "sagesla".
    block_q/block_k: block-map granularity of the sparse branch.
    linear_branch: False when every `proj_l` is zero — the linear
    compensation branch then contributes exactly zero and is skipped.
    v_quant: INT8 V granularity of the fused sagesla path: "channel" (per
    head and channel; K6 + K7) or "row" (per token; K18 + K19).
    jvp_mode: the forward-mode pass (the sCM tangent of rCM distillation,
    set by `models/wan.jvp_mode`; config.py:62-66): attention through the
    JVP wrappers whose tangent rule is K25 / K26 (ops/flash_jvp.py), plain
    norms, no fused or int8 path.
    """

    backend: str = "dense"
    sla_topk: float = 0.1
    block_q: int = 256
    block_k: int = 256
    feature_map: str = "softmax"
    linear_branch: bool = True
    v_quant: str = "channel"
    jvp_mode: bool = False


# the port's remat modes, and JAX's selective ones it refuses
REMAT_MODES = ("none", "block_wise", "full")
REMAT_LATER = ("mm_only", "attn_only", "self_attn_only")


@dataclass(frozen=True)
class WanConfig:
    """Wan2.1 diffusion-transformer architecture (config.py:86-144)."""

    arch: str = "wan2.1"
    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_h: int = 128
    rope_max_w: int = 128
    rope_max_t: int = 32
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    # W8A8 "postscale" linears inside the transformer blocks (--quant_linear;
    # ops/quant.py, kernels K8-K11)
    quant_linear: bool = False
    # compute dtype of the transformer trunk; norms/modulation stay fp32
    dtype: torch.dtype = torch.bfloat16
    # rematerialisation (config.py:122-125): "none", or "block_wise" / "full"
    # (each block recomputed in the backward, nothing saved inside it); the
    # selective modes wait (REMAT_LATER)
    remat: str = "none"

    def __post_init__(self):
        if self.remat in REMAT_LATER:
            raise NotImplementedError(
                f"remat {self.remat!r} (a selective mode, JAX's default under "
                f"an FSDP mesh) is not ported: the port takes "
                f"{', '.join(REMAT_MODES)} (ROADMAP Queue A item 11b)")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {self.remat!r}")
        if self.dim % self.num_heads:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by num_heads "
                f"({self.num_heads})")
        if (self.dim // self.num_heads) % 2:
            raise ValueError(
                f"head_dim ({self.dim // self.num_heads}) must be even "
                f"for 3D RoPE")

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def replace(self, **kw) -> "WanConfig":
        return dataclasses.replace(self, **kw)


def wan_config(model_name: str, **overrides) -> WanConfig:
    """Named model presets (config.py:147-167)."""
    presets = {
        "Wan2.1-1.3B": dict(
            arch="wan2.1", model_type="t2v", dim=1536, ffn_dim=8960,
            num_heads=12, num_layers=30, in_dim=16,
        ),
        "Wan2.1-14B": dict(
            arch="wan2.1", model_type="t2v", dim=5120, ffn_dim=13824,
            num_heads=40, num_layers=40, in_dim=16,
        ),
        "Wan2.2-A14B": dict(
            arch="wan2.2", model_type="i2v", dim=5120, ffn_dim=13824,
            num_heads=40, num_layers=40, in_dim=36,
        ),
    }
    if model_name not in presets:
        raise ValueError(f"Unknown model name: {model_name}. Options: {list(presets)}")
    kw = dict(presets[model_name])
    kw.update(overrides)
    return WanConfig(**kw)


def wan_test_config(**overrides) -> WanConfig:
    """Tiny config for tests (config.py:172-180): same topology, toy widths."""
    kw = dict(
        dim=48, ffn_dim=96, num_heads=2, num_layers=2, in_dim=16,
        text_dim=32, text_len=16, freq_dim=32,
        rope_max_h=16, rope_max_w=16, rope_max_t=8,
        dtype=torch.float32,
    )
    kw.update(overrides)
    return WanConfig(**kw)


@dataclass(frozen=True)
class GenerationConfig:
    """rCM consistency-sampling schedule (config.py:187-201)."""

    num_steps: int = 4
    sigma_max: float = 80.0
    mid_t: Tuple[float, ...] = (1.5, 1.4, 1.0)
    num_frames: int = 81
    resolution: str = "480p"
    aspect_ratio: str = "16:9"
    seed: int = 0
    num_samples: int = 1
    ode: bool = False
    boundary: float = 0.9
    fps: int = 16
