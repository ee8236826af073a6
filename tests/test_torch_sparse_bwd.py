"""The port's attention backward and its autograd Functions against JAX.

* K23 / K24's plain versions (ops/sparse_attention_bwd.py) against JAX's
  fused Pallas backward `_flash_bwd_fused(..., interpret=True)` on JAX's
  own hand-built case (tests/test_attention.py:158-179): L = 520, blocks
  128/128 (nQ = nK = 5, both tails ragged), K-blocks 3 and 4 never selected.
  fp32 atol 1e-5 (the same fp32 math in another summation order; the TPU
  kernel's online max against the plain version's exact one); bf16 atol
  2e-2 (P and dS round to bf16 before their products in both, at maxima
  that differ by the online rescaling).
* The gradients of the port's wrappers of K3, K4, K1, K2 and K21 (autograd
  Functions whose backward is K23 + K24, the dense reference, or a plain
  recompute) against `jax.grad` through `flash_attention(lut=...,
  interpret=True)`, dense `flash_attention`, `modulated_layer_norm`,
  `rmsnorm_rope` (each through its Pallas kernel in interpret mode) and
  `linear_attention_projected(interpret=True)`, fp32. Tolerance atol 1e-4
  + rtol 1e-4: fp32 gradients of magnitude ~1 summed over a few hundred
  keys in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.models.rope import rope_freqs_3d as rope_freqs_3d_jax
from turbodiffusion_tpu.ops import flash_pallas as fp
from turbodiffusion_tpu.ops import fused_norm as fn_jax
from turbodiffusion_tpu.ops.linear_attention_pallas import (
    linear_attention_projected as linear_projected_jax)
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import fused_norm as fn
from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
from turbodiffusion_tpu_torch.ops.flash_attention import (
    flash_attention, sparse_flash_attention)
from turbodiffusion_tpu_torch.ops.linear_attention import (
    linear_attention_projected)

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _randn(seed, *shape, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _jax_case():
    """tests/test_attention.py:166-173: B 1, L 520, 3 heads x 64."""
    B, L, H, D = 1, 520, 3, 64
    q, k, v, g = (_randn(s, B, L, H, D) for s in (7, 8, 9, 10))
    lut = np.asarray([[0, 1], [0, 1], [0, 1], [0, 2], [0, 2]], np.int32)
    return q, k, v, g, np.ascontiguousarray(np.broadcast_to(lut, (B, H, 5, 2)))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_k23_k24_plain_match_the_fused_pallas_backward(dtype, atol):
    q, k, v, g, lut = _jax_case()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    scale = q.shape[-1] ** -0.5
    want = fp._flash_bwd_fused(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                               jnp.asarray(lut), jnp.asarray(g).astype(jd),
                               scale=scale, block_q=128, block_k=128,
                               interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    tlut = torch.from_numpy(lut)
    dq, ld = sb.sparse_bwd_dq_plain(tq, tk, tv, tg, tlut, 128, 128, scale)
    inv = sb.inverse_lut(tlut, 5)
    assert inv[:, 3:, 0].eq(0).all() and inv[:, 0, 0].eq(5).all()
    dk, dv = sb.sparse_bwd_dkv_plain(tq, tk, tv, tg, ld, inv, 128, 128, scale)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=atol, rtol=0, err_msg=name)
    # never-selected K-blocks: exactly zero, as in the TPU kernel
    assert not dk[:, 384:].any() and not dv[:, 384:].any()


def _grads_t(fn_t, inputs, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn_t(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(g))


def _grads_j(fn_j, inputs, g):
    out, vjp = jax.vjp(fn_j, *(jnp.asarray(a) for a in inputs))
    return out, vjp(jnp.asarray(g))


def _assert_grads(got, want):
    (o_t, g_t), (o_j, g_j) = got, want
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               **GRAD_TOL, err_msg="output")
    assert len(g_t) == len(g_j)
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, f"input {i}: zero JAX gradient"
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL,
                                   err_msg=f"input {i}")


def test_k3_gradients_match_jax_flash_attention_with_lut():
    q, k, v, g, lut = _jax_case()
    got = _grads_t(lambda a, b, c: sparse_flash_attention(
        a, b, c, torch.from_numpy(lut), 128, 128), (q, k, v), g)
    want = _grads_j(lambda a, b, c: fp.flash_attention(
        a, b, c, lut=jnp.asarray(lut), interpret=True), (q, k, v), g)
    _assert_grads(got, want)


def test_k4_gradients_match_jax_dense_flash_attention():
    B, L, Lk, H, D = 1, 300, 72, 2, 64            # cross attention's shape
    q, g = _randn(20, B, L, H, D), _randn(21, B, L, H, D)
    k, v = _randn(22, B, Lk, H, D), _randn(23, B, Lk, H, D)
    got = _grads_t(flash_attention, (q, k, v), g)
    want = _grads_j(lambda a, b, c: fp.flash_attention(a, b, c,
                                                       interpret=True),
                    (q, k, v), g)
    _assert_grads(got, want)


@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k1_gradients_match_jax_modulated_layer_norm(mode):
    B, L, D = 1, 264, 256
    x, g = _randn(30, B, L, D), _randn(31, B, L, D)
    if mode == "mod":
        extra = (_randn(32, B, 1, D, std=0.5), _randn(33, B, 1, D, std=0.5))
        t = lambda x_, s_, b_: fn.modulated_layer_norm(x_, s_, b_)  # noqa: E731
        j = lambda x_, s_, b_: fn_jax.modulated_layer_norm(  # noqa: E731
            x_, s_, b_, interpret=True)
    else:
        extra = (1 + _randn(34, D, std=0.1), _randn(35, D, std=0.1))
        t = lambda x_, w_, b_: fn.modulated_layer_norm(  # noqa: E731
            x_, weight=w_, bias=b_)
        j = lambda x_, w_, b_: fn_jax.modulated_layer_norm(  # noqa: E731
            x_, weight=w_, bias=b_, interpret=True)
    _assert_grads(_grads_t(t, (x, *extra), g), _grads_j(j, (x, *extra), g))


@pytest.mark.parametrize("rope", [True, False])
def test_k2_gradients_match_jax_rmsnorm_rope(rope):
    B, T, Hs, Ws, H, Dh = 1, 2, 4, 6, 2, 128
    L = T * Hs * Ws
    x, w = _randn(40, B, L, H * Dh), 1 + _randn(41, H * Dh, std=0.1)
    g = _randn(42, B, L, H, Dh)
    cs_t = cs_j = (None, None)
    if rope:
        cs_t = fn.rope_cos_sin_full(rope_freqs_3d(T, Hs, Ws, Dh))
        cs_j = fn_jax.rope_cos_sin_full(rope_freqs_3d_jax(T, Hs, Ws, Dh))
    got = _grads_t(lambda x_, w_: fn.rmsnorm_rope(x_, w_, *cs_t, num_heads=H),
                   (x, w), g)
    want = _grads_j(lambda x_, w_: fn_jax.rmsnorm_rope(
        x_, w_, *cs_j, num_heads=H, interpret=True), (x, w), g)
    _assert_grads(got, want)


def test_k21_gradients_match_jax_linear_attention_projected():
    B, L, H, D = 1, 300, 2, 64
    q, k, v, g = (_randn(s, B, L, H, D) for s in (50, 51, 52, 53))
    w, b = _randn(54, D, D, std=0.2), _randn(55, D, std=0.2)
    # the port's weight is the (out, in) Linear weight, JAX's (in, out)
    got = _grads_t(lambda a, b_, c, w_, bb: linear_attention_projected(
        a, b_, c, w_.t(), bb), (q, k, v, w, b), g)
    want = _grads_j(lambda a, b_, c, w_, bb: linear_projected_jax(
        a, b_, c, w_, bb, interpret=True), (q, k, v, w, b), g)
    _assert_grads(got, want)
