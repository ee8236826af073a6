"""K1 / K2 (ops/fused_norm.py of the PyTorch port) against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernels in interpret
mode (`_mln_pallas`, `_rmsrope_pallas`) and through the port's wrappers,
which take their plain versions on CPU tensors. Shapes follow
tests/test_fused_norm.py: DIM 256, 2 heads x 128, SEQ 528 (a ragged tail
for the 128-row Pallas blocks). Tolerances: fp32 atol 1e-5 (the same fp32
math in another summation order); bf16 atol 2e-2 as in test_fused_norm.py,
plus rtol 2^-8: where the two frameworks round an fp32 intermediate to
neighbouring bf16 values, the output moves by one bf16 step, which is
0.03125 for outputs in [4, 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.models.rope import rope_freqs_3d as rope_freqs_3d_jax
from turbodiffusion_tpu.ops.fused_norm import (
    _mln_pallas, _rmsrope_pallas, rope_cos_sin_full as rope_cos_sin_full_jax)
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import fused_norm as fn

B, T, H_SP, W_SP = 1, 2, 4, 6
SEQ = T * H_SP * W_SP * 11          # 528
DIM, HEADS, DH = 256, 2, 128
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}


def _inputs(dtype: str):
    r = np.random.RandomState(0)
    x = r.randn(B, SEQ, DIM).astype(np.float32)
    e = r.randn(B, 6, DIM).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(DIM)).astype(np.float32)
    bias = (0.1 * r.randn(DIM)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    jax_in = dict(x=jnp.asarray(x).astype(jd), ms=jnp.asarray(e[:, 1]),
                  mb=jnp.asarray(e[:, 0]), w=jnp.asarray(w).astype(jd),
                  b=jnp.asarray(bias).astype(jd))
    torch_in = dict(x=torch.from_numpy(x).to(td), ms=torch.from_numpy(e[:, 1]),
                    mb=torch.from_numpy(e[:, 0]), w=torch.from_numpy(w).to(td),
                    b=torch.from_numpy(bias).to(td))
    return jax_in, torch_in


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["mod", "affine", "plain"])
def test_k1_plain_matches_mln_pallas(mode, dtype):
    """K1 in its three modes: AdaLN modulation (norm1/norm2), affine
    (norm3), and the bare layer norm."""
    j, t = _inputs(dtype)
    use_mod, use_aff = mode == "mod", mode == "affine"
    want = _mln_pallas(j["x"], j["ms"] if use_mod else None,
                       j["mb"] if use_mod else None,
                       j["w"] if use_aff else None, j["b"] if use_aff else None,
                       1e-6, interpret=True, block_l=128)
    got = fn.modulated_layer_norm(
        t["x"], t["ms"][:, None] if use_mod else None,
        t["mb"][:, None] if use_mod else None,
        t["w"] if use_aff else None, t["b"] if use_aff else None, eps=1e-6)
    assert got.dtype == t["x"].dtype and got.shape == t["x"].shape
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=ATOL[dtype], rtol=RTOL[dtype])


def test_rope_tables_match_jax():
    """rope_freqs_3d and the rotate-half tables equal the JAX ones."""
    fj = rope_freqs_3d_jax(T, H_SP, W_SP * 11, DH)
    ft = rope_freqs_3d(T, H_SP, W_SP * 11, DH)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)
    cj, sj = rope_cos_sin_full_jax(fj)
    ct, st = fn.rope_cos_sin_full(ft)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [True, False])
def test_k2_plain_matches_rmsrope_pallas(rope, dtype):
    """K2 with rotate-half RoPE (self-attention Q/K) and without (cross Q)."""
    j, t = _inputs(dtype)
    cj = sj = ct = st = None
    if rope:
        cj, sj = rope_cos_sin_full_jax(rope_freqs_3d_jax(T, H_SP, W_SP * 11, DH))
        ct, st = fn.rope_cos_sin_full(rope_freqs_3d(T, H_SP, W_SP * 11, DH))
    want = _rmsrope_pallas(j["x"], j["w"], cj, sj, 1e-5, HEADS,
                           interpret=True, block_l=128)
    got = fn.rmsnorm_rope(t["x"], t["w"], ct, st, num_heads=HEADS, eps=1e-5)
    assert got.shape == (B, SEQ, HEADS, DH) and got.dtype == t["x"].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).reshape(B, SEQ, HEADS, DH),
                               atol=ATOL[dtype], rtol=RTOL[dtype])


def test_wrappers_count_no_launch_on_cpu():
    """On a CPU tensor the wrappers run the plain version: no launch."""
    _, t = _inputs("bfloat16")
    before = (fn._mln_cuda.launches, fn._rmsrope_cuda.launches)
    fn.modulated_layer_norm(t["x"], t["ms"], t["mb"])
    fn.rmsnorm_rope(t["x"], t["w"], num_heads=HEADS)
    assert (fn._mln_cuda.launches, fn._rmsrope_cuda.launches) == before
