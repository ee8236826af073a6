"""Tiny Wan DiT forward: JAX `wan_forward` vs the PyTorch port's WanModel.

Both take the same parameters (the JAX init, as numpy, loaded into the port
by utils/jax_params) and the same numpy-seeded inputs, in fp32. The
zero-initialised head (and, for the linear branch, `proj_l`) is replaced by
seeded values: with them at zero the velocity is identically zero and the
comparison would prove nothing. Tolerance: fp32 atol 1e-4 on velocities of
magnitude ~1 after two blocks (fp32 matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
from turbodiffusion_tpu.models.wan import (
    init_wan_params as init_wan_params_jax, wan_forward)
from turbodiffusion_tpu_torch.config import AttentionConfig, wan_test_config
from turbodiffusion_tpu_torch.models.wan import WanModel, patchify, unpatchify
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _models(backend: str, linear_branch: bool):
    attn = dict(backend=backend, sla_topk=0.5, block_q=8, block_k=8,
                linear_branch=linear_branch)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn))
    cfg_t = wan_test_config(attention=AttentionConfig(**attn))
    # jitted: the same threefry draws as the eager init, one compile
    params = _numpy_tree(jax.jit(init_wan_params_jax, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))
    r = np.random.RandomState(1)
    head = params["head"]["head"]
    head["w"] = (0.05 * r.randn(*head["w"].shape)).astype(np.float32)
    head["b"] = (0.05 * r.randn(*head["b"].shape)).astype(np.float32)
    if linear_branch:
        pl_ = params["blocks"]["self_attn"]["proj_l"]
        pl_["w"] = (0.2 * r.randn(*pl_["w"].shape)).astype(np.float32)
        pl_["b"] = (0.2 * r.randn(*pl_["b"].shape)).astype(np.float32)
    model = load_jax_params(WanModel(cfg_t), params)
    return cfg_j, params, model


def _inputs():
    r = np.random.RandomState(2)
    x = r.randn(1, 16, 2, 8, 8).astype(np.float32)
    t = np.full((1, 1), 537.0, np.float32)
    ctx = r.randn(1, 16, 32).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("backend,linear_branch", [
    ("dense", False), ("sla", False), ("sla", True)])
def test_wan_forward_matches_jax(backend, linear_branch):
    cfg_j, params, model = _models(backend, linear_branch)
    x, t, ctx = _inputs()
    want = np.asarray(wan_forward(jax.tree.map(jnp.asarray, params), cfg_j,
                                  jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1            # the seeded head is live
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_linear_branch_refuses_non_cpu_tensors(monkeypatch):
    """A non-zero proj_l runs K21 (linear_attention_projected) past the
    sparse branch: a tensor on neither the CPU nor a card (meta) raises
    instead of running plain torch there; so does K21's planes form (the
    sparse kernel is stubbed)."""
    from turbodiffusion_tpu_torch.ops import attention as attn
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    monkeypatch.setattr(attn, "sparse_flash_attention",
                        lambda q, *a, **k: torch.zeros_like(q))
    cfg = AttentionConfig(backend="sla", block_q=8, block_k=8)
    q = torch.zeros(1, 16, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attn.sla_attention(q, q, q, torch.nn.Linear(8, 8, device="meta"), cfg)
    p = torch.zeros(1, 2, 512, 128, device="meta")
    w = torch.zeros(128, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        la.linear_projected_planes(p, p, p, w, w[0], 500)


def test_composable_sagesla_refuses_non_cpu_tensors():
    """sagesla outside the fused geometry at blocks < 128 runs the int8-QK
    gather (K20), and the row path runs K18 / K19: their wrappers refuse a
    tensor on neither the CPU nor a card (meta) instead of running plain
    torch there, as the fused path's wrappers do. At blocks >= 128 (a head
    dim that is no multiple of 128) a non-CPU tensor raises naming its
    ROADMAP item."""
    from turbodiffusion_tpu_torch.ops import attention as attn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    cfg = AttentionConfig(backend="sagesla", block_q=8, block_k=8)
    q = torch.zeros(1, 16, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attn.attention(q, q, q, cfg)
    cfg128 = AttentionConfig(backend="sagesla", block_q=128, block_k=128)
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        attn.attention(q, q, q, cfg128)
    x = torch.zeros(1, 16, 256, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sf.head_planes(x, num_heads=2)
    kp = torch.zeros(1, 2, 512, 128, device="meta")
    i8 = torch.zeros(1, 2, 512, 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sf.subquant_pack_kvt(kp, None, None, 256)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sf.subquant_pack_kv(kp, None, i8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        si8.sparse_attention_i8_vt(i8, None, i8, None, None, None, None,
                                   block_q=512)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        si8.sparse_attention_i8_planes(i8, None, i8, None, None, None,
                                       block_q=512)


def test_patchify_and_unpatchify_match_jax():
    from turbodiffusion_tpu.models.wan import patchify as patchify_jax
    from turbodiffusion_tpu.models.wan import unpatchify as unpatchify_jax
    x = np.arange(2 * 4 * 2 * 6 * 8, dtype=np.float32).reshape(2, 4, 2, 6, 8)
    p = patchify(torch.from_numpy(x), (1, 2, 2))
    assert p.shape == (2, 2 * 3 * 4, 16)
    np.testing.assert_array_equal(p.numpy(), np.asarray(patchify_jax(x, (1, 2, 2))))
    np.testing.assert_array_equal(
        unpatchify(p, 2, 3, 4, (1, 2, 2), 4).numpy(),
        np.asarray(unpatchify_jax(p.numpy(), 2, 3, 4, (1, 2, 2), 4)))
