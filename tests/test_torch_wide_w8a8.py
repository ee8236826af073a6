"""The wide-model (Wan2.1-14B: dim 5120, 40 heads of 128) W8A8 path of the
port against the JAX package: one W8A8 block and a 2-layer W8A8 forward,
against JAX with its wide TPU branches taken (the backend reported as
"tpu", every Pallas entry point in interpret mode, its calls counted).
The helpers, the configuration and the 5120-wide test tree (`wide_tree`)
are test_torch_wide.py's; this file holds the W8A8 half so that the two
halves run on two workers.

Tolerance: atol 2^-6 * max |y|, the W8A8 block rule of
test_torch_int8_feeds.py: bf16 outputs and int8 values one LSB apart
upstream of a GEMM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turbodiffusion_tpu.models.wan as wan_jax
from tests.test_torch_wide import (ATTN, DH, GRID, HD, SIZE, _patch_tpu_jax,
                                   _rand, _spy_port, wide_tree)  # noqa: F401
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu_torch import config as config_t
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.ops.fused_norm import rope_cos_sin_full
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params


# ---------------------------------------------------------------------------
# one W8A8 block and a 2-layer forward against JAX with its TPU branches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w8a8_models(wide_tree):
    """The JAX config, the JAX W8A8 tree (`quantize_wan_blocks`, unfused
    QKV as JAX quantises dim >= 4096) and the port's WanModel loaded from
    it: SIZE, 2 layers. Built once for the block test (layer 0) and the
    forward test."""
    cfg_j, params = wide_tree
    cfg_t = config_t.wan_test_config(
        attention=config_t.AttentionConfig(**ATTN), dtype=torch.bfloat16,
        quant_linear=True, num_layers=2, **SIZE)
    qtree = dict(params)
    qtree["blocks"] = jax.tree.map(np.array, quant_jax.quantize_wan_blocks(
        jax.tree.map(jnp.asarray, params["blocks"]), mode="postscale",
        fuse_qkv=False))
    # no random init (the load overwrites every value); zeros keep the
    # quantiser's input finite
    model = WanModel(cfg_t, device="meta").to_empty(device="cpu")
    for t in model.parameters():
        t.detach().zero_()
    quant.quantize_wan_blocks(model.blocks, fuse_qkv=False)
    load_jax_params(model, qtree)
    return cfg_j, qtree, model


# per block: JAX's wide composition (K12 x3, K9 q / k / v / o / cross q /
# cross o + text k / v, K15 x3, K5 x3 in head groups, K6, K7, K16, K17, K10,
# K11)
JAX_BLOCK_CALLS = {
    "_mln_pallas": 3, "sla_attention_fused": 1, "row_rms_inv": 3,
    "unfold_quant": 1, "_unfold_scale_kernel": 1, "_unfold_write_kernel": 1,
    "cross_attention_qout": 1, "_cross_attention_qout_wide": 1,
    "int8_gemm_postscale_pallas": 8, "quantize_rows_int8_pallas": 2,
    "int8_gemm_postscale_qout_pallas": 1, "int8_gemm_blockact_pallas": 1}
PORT_BLOCK_CALLS = {"row_rms_inv_plain": 3, "unfold_quant_wide_plain": 1,
                    "cross_attention_qout_wide_plain": 1}


def test_w8a8_wide_block_matches_jax_wan_block(monkeypatch, w8a8_models):
    """WanAttentionBlock at dim 5120, 40 heads, FFN 1536, 256 tokens, W8A8
    with unfused Q / K / V loaded from the JAX tree, against JAX
    `wan_block` taking its wide TPU composition (row_rms_inv, the two wide
    unfold passes and the wide cross kernel, all counted)."""
    cfg_j, qtree, model = w8a8_models
    blk = model.blocks[0]
    sa = blk.self_attn
    assert sa.qkv is None and all(isinstance(m, quant.Int8Linear)
                                  for m in (sa.q, sa.k, sa.v, sa.o))
    n = int(np.prod(GRID))
    x, e0, ctx = _rand((1, n, HD), 40), _rand((1, 6, HD), 41, 0.1), \
        _rand((1, 16, HD), 42)
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(*GRID, DH))

    port_calls = {}
    _spy_port(monkeypatch, port_calls)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).bfloat16(), torch.from_numpy(e0),
                  (cosF, sinF), torch.from_numpy(ctx).bfloat16()).float().numpy()
    assert port_calls == PORT_BLOCK_CALLS, port_calls

    jax_calls = {}
    _patch_tpu_jax(monkeypatch, jax_calls)
    block_j = jax.tree.map(lambda a: jnp.asarray(a[0]), qtree["blocks"])
    want = np.asarray(wan_jax.wan_block(
        block_j, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e0),
        (jnp.asarray(cosF.numpy()), jnp.asarray(sinF.numpy())),
        jnp.asarray(ctx, jnp.bfloat16), cfg_j), np.float32)
    assert jax_calls == JAX_BLOCK_CALLS, jax_calls
    assert got.shape == want.shape == (1, n, HD)
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * scale)


def test_w8a8_wide_forward_matches_jax(monkeypatch, w8a8_models):
    """The slice as a whole at small depth: a 2-layer W8A8 WanModel at dim
    5120 (weights carried across by `load_jax_params`, a random head) on a
    (1, 16, 2, 16, 32) latent, 256 tokens, against JAX `wan_forward` forced
    onto the same wide TPU composition."""
    cfg_j, qtree, model = w8a8_models
    x = _rand((1, 16, 2, 16, 32), 50)
    t = np.full((1, 1), 537.0, np.float32)
    ctx = _rand((1, 16, 32), 51)
    port_calls = {}
    _spy_port(monkeypatch, port_calls)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).float().numpy()
    assert port_calls == {k: 2 * v for k, v in PORT_BLOCK_CALLS.items()}

    jax_calls = {}
    _patch_tpu_jax(monkeypatch, jax_calls)
    want = np.asarray(wan_jax.wan_forward(
        jax.tree.map(jnp.asarray, qtree), cfg_j, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx)), np.float32)
    # the blocks run under one scan: each entry point traced once
    assert jax_calls == JAX_BLOCK_CALLS, jax_calls
    assert got.shape == want.shape == x.shape
    scale = np.abs(want).max()
    assert scale > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * scale)
