"""K1 / K2 (ops/fused_norm.py of the PyTorch port) against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernels in interpret
mode (`_mln_pallas`, `_rmsrope_pallas`) and through the port's wrappers,
which take their plain versions on CPU tensors. Shapes follow
tests/test_fused_norm.py: DIM 256, 2 heads x 128, SEQ 528 (a ragged tail
for the 128-row Pallas blocks); K2 also above H*Dh 4096 (40 and 48 heads
of 128, 48 rows, bf16). Tolerances: fp32 atol 1e-5 (the same fp32
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


def _wide_inputs(heads: int, seq: int = 48):
    """bf16 (x, w) of H*Dh = heads x 128 channels, as numpy-seeded pairs."""
    r = np.random.RandomState(1)
    x = r.randn(B, seq, heads * DH).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(heads * DH)).astype(np.float32)
    return ((jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)),
            (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()))


# the model's width (2 x 128) in both dtypes; above H*Dh 4096 in bf16: the
# 14B's 40 x 128 and 48 x 128 (6144, wider than any model of the repo)
K2_CASES = [pytest.param(rope, HEADS, dtype, id=f"{rope}-{dtype}")
            for dtype in ("float32", "bfloat16") for rope in (True, False)]
K2_CASES += [pytest.param(rope, heads, "bfloat16", id=f"{rope}-{heads}x128")
             for heads in (40, 48) for rope in (True, False)]


@pytest.mark.parametrize("rope,heads,dtype", K2_CASES)
def test_k2_plain_matches_rmsrope_pallas(rope, heads, dtype):
    """K2 with rotate-half RoPE (self-attention Q/K) and without (cross Q),
    at the model's width and above H*Dh 4096 (48 rows there)."""
    if heads == HEADS:
        j, t = _inputs(dtype)
        (xj, wj), (xt, wt) = (j["x"], j["w"]), (t["x"], t["w"])
    else:
        (xj, wj), (xt, wt) = _wide_inputs(heads)
    seq = xt.shape[1]
    cj = sj = ct = st = None
    if rope:
        cj, sj = rope_cos_sin_full_jax(rope_freqs_3d_jax(T, H_SP, W_SP * 11, DH))
        ct, st = fn.rope_cos_sin_full(rope_freqs_3d(T, H_SP, W_SP * 11, DH))
        cj, sj, ct, st = cj[:seq], sj[:seq], ct[:seq], st[:seq]
    want = _rmsrope_pallas(xj, wj, cj, sj, 1e-5, heads, interpret=True,
                           block_l=128)
    got = fn.rmsnorm_rope(xt, wt, ct, st, num_heads=heads, eps=1e-5)
    assert got.shape == (B, seq, heads, DH) and got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).reshape(B, seq, heads, DH),
                               atol=ATOL[dtype], rtol=RTOL[dtype])


def test_wrappers_count_no_launch_on_cpu():
    """On a CPU tensor the wrappers run the plain version: no launch."""
    _, t = _inputs("bfloat16")
    before = (fn._mln_cuda.launches, fn._rmsrope_cuda.launches)
    fn.modulated_layer_norm(t["x"], t["ms"], t["mb"])
    fn.rmsnorm_rope(t["x"], t["w"], num_heads=HEADS)
    assert (fn._mln_cuda.launches, fn._rmsrope_cuda.launches) == before


# which kernel form a K2 / K1 launch takes: pointers as numbers (16-byte
# aligned BASE, a column group 3072 bytes in, 2 bytes off), row strides
BASE = 1 << 20
K2_FORMS = [
    ((12, 128, 1536, BASE), "vector"),              # 1.3B q / k / cross q
    ((12, 128, 4608, BASE + 3072), "vector"),       # its fused QKV K group
    ((40, 128, 5120, BASE), "vector"),              # 14B
    ((48, 128, 6144, BASE), "vector"),
    ((24, 64, 1536, BASE), "vector"),
    ((1, 16, 16, BASE), "vector"),
    ((2, 256, 512, BASE), "vector"),
    ((4, 6, 24, BASE), "loop"),                     # head dim 6
    ((3, 48, 144, BASE), "loop"),                   # not a power of two
    ((2, 512, 1024, BASE), "loop"),                 # head wider than a warp
    ((12, 128, 1540, BASE), "loop"),                # row stride off 8
    ((12, 128, 1536, BASE + 2), "loop"),            # unaligned view
    ((65, 128, 8320, BASE), "loop"),                # above 8192
]


@pytest.mark.parametrize("args,form", K2_FORMS,
                         ids=[f"{a[0]}x{a[1]}-ld{a[2]}-off{a[3] - BASE}"
                              for a, _ in K2_FORMS])
def test_rmsrope_form_by_shape(args, form):
    """K2's warp-per-row kernel takes head dims 16-256 (powers of two),
    rows to 8192, row strides that are multiples of 8 and aligned views;
    the loop takes the rest. Tables present or not, aligned tables do not
    change the form; an unaligned table does."""
    H, Dh, ld, x = args
    assert fn.rmsrope_form(H, Dh, ld, x, BASE, BASE + 64, None, None) == form
    assert fn.rmsrope_form(H, Dh, ld, x, BASE, BASE + 64, BASE, BASE + 4096) == form
    assert fn.rmsrope_form(H, Dh, ld, x, BASE, BASE + 64, BASE + 4, BASE) == "loop"


@pytest.mark.parametrize("D,x,form", [(1536, BASE, "vector"), (5120, BASE, "vector"),
                                      (256, BASE, "vector"), (1540, BASE, "loop"),
                                      (1536, BASE + 2, "loop"), (8200, BASE, "loop")])
def test_mln_form_by_shape(D, x, form):
    """K1's warp-per-row kernel takes D a multiple of 8 up to 8192 with
    aligned operands (absent ones as None); the block-per-row kernel the
    rest."""
    assert fn.mln_form(D, x, BASE, None, None, BASE, BASE) == form
    assert fn.mln_form(D, x, BASE, BASE, BASE, None, None) == form
    assert fn.mln_form(D, x, BASE, BASE + 8, BASE, None, None) == "loop"


@pytest.mark.parametrize("D,x,form", [(1536, BASE, "vector"), (5120, BASE, "vector"),
                                      (8192, BASE, "vector"), (1540, BASE, "loop"),
                                      (1536, BASE + 2, "loop"), (8200, BASE, "loop")])
def test_mln_quant_form_by_shape(D, x, form):
    """K12 takes K1's rule: the warp-per-row kernel with an int8 epilogue for
    D a multiple of 8 up to 8192 with aligned operands (the int8 output in
    out's place); the block-per-row `mln_kernel<true>` the rest, an int8
    output off 16-byte alignment among them."""
    assert fn.mln_quant_form(D, x, BASE, None, None, BASE, BASE) == form
    assert fn.mln_quant_form(D, x, BASE, BASE, BASE, None, None) == form
    assert fn.mln_quant_form(D, x, BASE + 8, BASE, BASE, None, None) == "loop"
    assert fn.mln_quant_form(D, x, BASE, BASE, BASE, None, None) == fn.mln_form(
        D, x, BASE, BASE, BASE, None, None)


def test_form_limit_matches_the_kernel_source():
    """The widest vector-form row the form functions allow is the one the
    CUDA source's constants give: 8 elements x 32 lanes x row warps x
    vectors a lane (csrc/warp_rows.cuh, which K1, K2, K12 and K5 share)."""
    import re
    from pathlib import Path
    src = (Path(fn.__file__).resolve().parent.parent / "csrc" / "warp_rows.cuh").read_text()
    vpl = int(re.search(r"constexpr int kMaxVpl = (\d+);", src).group(1))
    warps = int(re.search(r"constexpr int kMaxRowWarps = (\d+);", src).group(1))
    assert 8 * 32 * warps * vpl == fn._VEC_MAX_ROW
