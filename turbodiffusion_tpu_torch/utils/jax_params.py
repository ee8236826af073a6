"""Load the JAX package's parameter trees into the port's modules.

The JAX package keeps parameters as nested dicts (lists for the VAE's layer
sequences). This module takes such a tree with numpy leaves — no jax import
— and copies it into a `WanModel`, `UMT5Encoder` or `WanVAE`, so that both
packages compute the same function. It walks the module's parameters and
buffers by name:
  * `weight` / `bias` map to the tree's `w` / `b`; an `nn.Linear` weight and
    an `Int8Linear`'s `w_int8` buffer are transposed, because JAX stores
    linears (in, out); the `Int8Linear`'s `scale` buffer is the tree's
    `scale` (a tree quantised by `quantize_wan_blocks`, with its fused
    `self_attn.qkv` below dim 4096 or separate q / k / v above, loads into
    blocks quantised the same way);
  * a name that indexes a stacked subtree (the DiT's and umT5's `blocks`,
    whose leaves carry a leading num_layers axis) selects that layer;
  * where the tree holds a bare array (umT5's bias-free linears), it is the
    weight;
  * a few leaf names differ: see `_RENAME`.
Tree leaves the module has no parameter for (the VAE encoder, `shortcut:
None`) are ignored; a module parameter the tree lacks raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_RENAME = {
    "weight": ("w",), "bias": ("b",),
    "norm_q": ("norm_q", "scale"), "norm_k": ("norm_k", "scale"),
    "norm3_weight": ("norm3", "scale"), "norm3_bias": ("norm3", "bias"),
    "norm1": ("norm1", "w"), "norm2": ("norm2", "w"), "norm": ("norm", "w"),
    "w_int8": ("w_int8",), "scale": ("scale",),
}


def _to_numpy(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: widen exactly
        a = a.astype(np.float32)
    return a


def _walk(tree, parts):
    """Follow `parts` through the tree; an integer part into a dict selects
    a layer of a stacked subtree. Returns (node, layer index or None)."""
    node, layer = tree, None
    for part in parts:
        if isinstance(node, (list, tuple)):
            node = node[int(part)]
        elif part.isdigit():
            layer = int(part)
        else:
            node = node[part]
    return node, layer


@torch.no_grad()
def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (numpy leaves) into `module`, in place."""
    for mname, mod in module.named_modules():
        mparts = mname.split(".") if mname else []
        for pname, param in (*mod.named_parameters(recurse=False),
                             *mod.named_buffers(recurse=False)):
            node, layer = _walk(tree, mparts)
            if isinstance(node, dict):
                node, layer2 = _walk(node, _RENAME.get(pname, (pname,)))
                layer = layer if layer2 is None else layer2
            elif pname != "weight":
                raise KeyError(f"{mname}.{pname}: tree holds a bare array")
            arr = _to_numpy(node)
            if layer is not None:
                arr = arr[layer]
            if (isinstance(mod, nn.Linear) and pname == "weight") \
                    or pname == "w_int8":
                arr = arr.T
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{mname}.{pname}: tree shape {arr.shape} != "
                                 f"parameter shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module
