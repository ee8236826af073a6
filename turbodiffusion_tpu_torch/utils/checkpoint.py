"""Checkpoint import and export: reference state dicts <-> the port's modules.

Ports `turbodiffusion_tpu/utils/checkpoint.py` over torch tensors (no numpy
round trip, bf16 stays bf16 until it is copied into a module):
  * `load_torch_state_dict` (:36-51): `.pth` / `.pt` through `torch.load`
    (weights only, memory-mapped), `.safetensors` through the `safetensors`
    package;
  * `strip_prefix` (:54-65): drops `net.`, prefers `net_ema.`;
  * `wan_params_from_state_dict` (:89-192): a reference WanModel state dict
    (rcm/networks/wan2pt1.py naming) -> the port's `WanModel`. Each linear
    keeps the layout it has on disk (`_lin` :72-86): float, postscale
    `Int8Linear` (`int8_weight` + a 1-D scale) or block `Int8BlockLinear`
    (`int8_weight` + a 2-D scale, one per 128x128 block, the reference's
    quantised checkpoints). Both store (out, in), the port's layout, so no
    weight or scale is transposed (JAX transposes both). Self-attention Q /
    K and norm_q / norm_k get the RoPE channel permutation
    (`models/rope.permute_qk_linear`); `proj_l` is read from
    `self_attn.attn_op.local_attn.proj_l` and zero-filled when absent;
    `patch_embedding` may be stored as a Conv3d. I2V keys (`k_img`,
    `img_emb`) are refused: I2V is ROADMAP Queue A item 10;
  * `vae_params_from_state_dict` (:224-271): a Wan2.1_VAE.pth state dict ->
    the port's `WanVAE` (the decoder and `conv2`; the port has no encoder
    yet, so the encoder's keys are ignored);
  * `umt5_params_from_state_dict` (:278-304): models_t5_umt5-xxl-enc-bf16.pth
    -> the port's `UMT5Encoder`;
  * `wan_state_dict_from_params` (:311-378): the inverse of the DiT import,
    in the reference's naming;
  * `merge_models` (:385-391): task-arithmetic merging, over state dicts.

Each module is built on the meta device and then materialised on `device`
with every parameter and buffer copied from the checkpoint (a strict load:
a missing key raises), so no random init is spent on weights that are
overwritten.
"""

from __future__ import annotations

import copy
import re
from typing import Dict

import torch

from turbodiffusion_tpu_torch.config import WanConfig
from turbodiffusion_tpu_torch.models.rope import (
    permute_qk_linear, rope_channel_permutation)
from turbodiffusion_tpu_torch.models.umt5 import UMT5Config, UMT5Encoder
from turbodiffusion_tpu_torch.models.vae import VAEConfig, WanVAE
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops.quant import (
    LINEAR_LAYOUTS, Int8BlockLinear, Int8Linear)

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# raw loading
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> StateDict:
    """A .pth / .pt / .safetensors file as a dict of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def strip_prefix(sd: StateDict, prefix: str = "net.") -> StateDict:
    """Drop a training-wrapper prefix; prefer `net_ema.` keys when both
    exist (dcp_to_pth.py extracts the EMA weights)."""
    ema = {k[len("net_ema."):]: v for k, v in sd.items()
           if k.startswith("net_ema.")}
    if ema:
        return ema
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out if out else dict(sd)


# ---------------------------------------------------------------------------
# Wan DiT
# ---------------------------------------------------------------------------

def linear_layout(sd: StateDict, name: str) -> str:
    """"float", "postscale" or "block": the layout of linear `name` on disk."""
    if f"{name}.int8_weight" not in sd:
        return "float"
    return "block" if sd[f"{name}.scale"].dim() == 2 else "postscale"


def checkpoint_layout(sd: StateDict) -> str:
    """The layout of a DiT checkpoint's block linears (that of the first
    block's self-attention Q)."""
    return linear_layout(sd, "blocks.0.self_attn.q")


# (port name, reference name) of every linear of a block
_BLOCK_LINEARS = [(f"{a}.{c}", f"{a}.{c}") for a in ("self_attn", "cross_attn")
                  for c in ("q", "k", "v", "o")] + [("ffn.fc1", "ffn.0"),
                                                    ("ffn.fc2", "ffn.2")]


def _put_linear(out: StateDict, sd: StateDict, dst: str, src: str):
    for s, d in (("weight", "weight"), ("int8_weight", "w_int8"),
                 ("scale", "scale"), ("bias", "bias")):
        if f"{src}.{s}" in sd:
            out[f"{dst}.{d}"] = sd[f"{src}.{s}"]


def _port_state_dict(sd: StateDict, cfg: WanConfig, with_proj_l: bool):
    """The reference's keys under the port's module names (wan.py naming)."""
    D, dh = cfg.dim, cfg.head_dim
    out: StateDict = {}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for dst, src in _BLOCK_LINEARS:
            _put_linear(out, sd, f"{pre}.{dst}", f"{pre}.{src}")
        for a in ("self_attn", "cross_attn"):
            for n in ("norm_q", "norm_k"):
                out[f"{pre}.{a}.{n}"] = sd[f"{pre}.{a}.{n}.weight"]
        if with_proj_l:
            # SLA checkpoints (modify_model.py:49-52); fp32 zero-init
            # otherwise (SLA/core.py:57, 78-81)
            src = f"{pre}.self_attn.attn_op.local_attn.proj_l"
            zero = {"weight": torch.zeros(dh, dh), "bias": torch.zeros(dh)}
            for n in ("weight", "bias"):
                out[f"{pre}.self_attn.proj_l.{n}"] = sd.get(f"{src}.{n}", zero[n])
        out[f"{pre}.modulation"] = sd[f"{pre}.modulation"].reshape(6, D)
        if cfg.cross_attn_norm:
            out[f"{pre}.norm3_weight"] = sd[f"{pre}.norm3.weight"]
            out[f"{pre}.norm3_bias"] = sd[f"{pre}.norm3.bias"]
    # patch_embedding may be a Conv3d (D, C, kt, kh, kw) (safetensors shards)
    out["patch_embedding.weight"] = sd["patch_embedding.weight"].reshape(D, -1)
    out["patch_embedding.bias"] = sd["patch_embedding.bias"]
    for dst, src in (("text_embedding.fc1", "text_embedding.0"),
                     ("text_embedding.fc2", "text_embedding.2"),
                     ("time_embedding.fc1", "time_embedding.0"),
                     ("time_embedding.fc2", "time_embedding.2"),
                     ("time_projection.fc", "time_projection.1"),
                     ("head.head", "head.head")):
        _put_linear(out, sd, dst, src)
    out["head.modulation"] = sd["head.modulation"].reshape(2, D)
    return out


@torch.no_grad()
def wan_params_from_state_dict(sd: StateDict, cfg: WanConfig,
                               device="cuda") -> WanModel:
    """A `WanModel` on `device` from a reference-named DiT state dict (see
    the module docstring)."""
    i2v = [k for k in sd if ".k_img." in k or ".v_img." in k
           or k.startswith("img_emb.")]
    if i2v or cfg.model_type != "t2v":
        raise NotImplementedError(
            f"I2V checkpoints ({(i2v or [cfg.model_type])[0]}, ...) wait for "
            "I2V (ROADMAP Queue A item 10)")
    with torch.device("meta"):
        model = WanModel(cfg)
    for i, blk in enumerate(model.blocks):
        for dst, src in _BLOCK_LINEARS:
            layout = linear_layout(sd, f"blocks.{i}.{src}")
            if layout != "float":
                parent, attr = dst.rsplit(".", 1)
                old = blk.get_submodule(parent).get_submodule(attr)
                setattr(blk.get_submodule(parent), attr, LINEAR_LAYOUTS[layout](
                    old.in_features, old.out_features, old.bias is not None,
                    device="meta", dtype=cfg.dtype))
    model = model.to_empty(device=device)
    with_proj_l = model.blocks[0].self_attn.proj_l is not None
    model.load_state_dict(_port_state_dict(sd, cfg, with_proj_l))
    perm = rope_channel_permutation(cfg.head_dim, cfg.num_heads).to(device)
    for blk in model.blocks:
        sa = blk.self_attn
        for lin in (sa.q, sa.k):
            permute_qk_linear(lin, cfg.head_dim, cfg.num_heads)
        for norm in (sa.norm_q, sa.norm_k):
            norm.copy_(norm[perm])
    return model


def wan_state_dict_from_params(model: WanModel, cfg: WanConfig) -> StateDict:
    """A reference-named state dict of `model` (the inverse of
    `wan_params_from_state_dict`): Q / K and norm_q / norm_k back in the
    interleaved channel order, each linear in its layout, tensors on the
    model's device. Q / K / V must be separate linears (on disk the
    reference keeps them so; `quantize_wan_blocks(fuse_qkv=False)`)."""
    sd: StateDict = {}

    def put(name, lin):
        if isinstance(lin, (Int8Linear, Int8BlockLinear)):
            sd[f"{name}.int8_weight"] = lin.w_int8.detach()
            sd[f"{name}.scale"] = lin.scale.detach()
        else:
            sd[f"{name}.weight"] = lin.weight.detach()
        if lin.bias is not None:
            sd[f"{name}.bias"] = lin.bias.detach()

    inv = torch.argsort(rope_channel_permutation(cfg.head_dim, cfg.num_heads))
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}"
        sa = blk.self_attn
        if sa.qkv is not None:
            raise ValueError("export takes separate Q / K / V linears, not "
                             "a fused qkv (quantize_wan_blocks(fuse_qkv=False))")
        for dst, src in _BLOCK_LINEARS:
            lin = blk.get_submodule(dst)
            if dst in ("self_attn.q", "self_attn.k"):
                lin = permute_qk_linear(copy.deepcopy(lin), cfg.head_dim,
                                        cfg.num_heads, inverse=True)
            put(f"{pre}.{src}", lin)
        for a in ("self_attn", "cross_attn"):
            for n in ("norm_q", "norm_k"):
                w = getattr(blk.get_submodule(a), n).detach()
                sd[f"{pre}.{a}.{n}.weight"] = (w[inv.to(w.device)]
                                               if a == "self_attn" else w)
        if sa.proj_l is not None:
            put(f"{pre}.self_attn.attn_op.local_attn.proj_l", sa.proj_l)
        sd[f"{pre}.modulation"] = blk.modulation.detach()[None]
        if cfg.cross_attn_norm:
            sd[f"{pre}.norm3.weight"] = blk.norm3_weight.detach()
            sd[f"{pre}.norm3.bias"] = blk.norm3_bias.detach()
    put("patch_embedding", model.patch_embedding)
    for src, lin in (("text_embedding.0", model.text_embedding["fc1"]),
                     ("text_embedding.2", model.text_embedding["fc2"]),
                     ("time_embedding.0", model.time_embedding["fc1"]),
                     ("time_embedding.2", model.time_embedding["fc2"]),
                     ("time_projection.1", model.time_projection["fc"]),
                     ("head.head", model.head.head)):
        put(src, lin)
    sd["head.modulation"] = model.head.modulation.detach()[None]
    return sd


# ---------------------------------------------------------------------------
# Wan VAE and umT5
# ---------------------------------------------------------------------------

# reference (rcm/tokenizers/wan2pt1.py) -> port (models/vae.py) key pieces
_VAE_RENAME = [(r"\.residual\.0\.gamma$", ".norm1.gamma"),
               (r"\.residual\.2\.", ".conv1."),
               (r"\.residual\.3\.gamma$", ".norm2.gamma"),
               (r"\.residual\.6\.", ".conv2."),
               (r"\.resample\.1\.", ".conv."),
               (r"^decoder\.head\.0\.gamma$", "decoder.head_norm.gamma"),
               (r"^decoder\.head\.2\.", "decoder.head_conv.")]


@torch.no_grad()
def vae_params_from_state_dict(sd: StateDict, cfg: VAEConfig = VAEConfig(),
                               device="cuda") -> WanVAE:
    """A `WanVAE` on `device` from a Wan2.1_VAE.pth state dict: the decoder
    and `conv2`; the encoder's keys (and `conv1`) are ignored."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.startswith("decoder.") or k.startswith("conv2."):
            for pat, rep in _VAE_RENAME:
                k = re.sub(pat, rep, k)
            out[k] = v
    with torch.device("meta"):
        vae = WanVAE(cfg)
    vae = vae.to_empty(device=device)
    vae.load_state_dict(out)
    return vae


@torch.no_grad()
def umt5_params_from_state_dict(sd: StateDict, cfg: UMT5Config = UMT5Config(),
                                device="cuda") -> UMT5Encoder:
    """A `UMT5Encoder` on `device` from a models_t5_umt5-xxl-enc-bf16.pth
    state dict (rcm/utils/umt5.py T5Encoder naming)."""
    out: StateDict = {"token_embedding": sd["token_embedding.weight"],
                      "norm": sd["norm.weight"]}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[f"{pre}.norm1"] = sd[f"{pre}.norm1.weight"]
        out[f"{pre}.norm2"] = sd[f"{pre}.norm2.weight"]
        out[f"{pre}.pos_embedding"] = sd[f"{pre}.pos_embedding.embedding.weight"]
        for c in ("q", "k", "v", "o"):
            out[f"{pre}.attn.{c}.weight"] = sd[f"{pre}.attn.{c}.weight"]
        out[f"{pre}.ffn.gate.weight"] = sd[f"{pre}.ffn.gate.0.weight"]
        for c in ("fc1", "fc2"):
            out[f"{pre}.ffn.{c}.weight"] = sd[f"{pre}.ffn.{c}.weight"]
    with torch.device("meta"):
        enc = UMT5Encoder(cfg)
    enc = enc.to_empty(device=device)
    enc.load_state_dict(out)
    return enc


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------

def merge_models(base: StateDict, target: StateDict, diff_base: StateDict,
                 weight: float = 1.0) -> StateDict:
    """Task-arithmetic grafting, base + weight * (target - diff_base), in
    fp32 for every floating key the three share; other keys of `base` as
    they are, and keys only `target` has (an SLA finetune's proj_l) carried
    over (merge_models.py:6-60; convert.py:133-152)."""
    out = {}
    for k, b in base.items():
        if k in target and k in diff_base and b.is_floating_point():
            out[k] = b.float() + weight * (target[k].float()
                                           - diff_base[k].float())
        else:
            out[k] = b
    for k, t in target.items():
        out.setdefault(k, t)
    return out
