"""K3 / K4 and the SLA block map (PyTorch port) against the JAX package.

The same numpy-seeded q/k/v go through the JAX Pallas flash kernels in
interpret mode (`flash_attention`, with and without a LUT), the JAX jnp
references, and the port's wrappers, which take their plain versions on CPU
tensors. Tolerances: fp32 atol 2e-5 (fp32 softmax attention in another
summation order, outputs of magnitude ~1); bf16 atol 2e-2 (the kernels'
bf16 probabilities and output rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.ops.attention import (
    get_block_map as get_block_map_jax, linear_attention as linear_attention_jax,
    sparse_attention_ref)
from turbodiffusion_tpu.ops.flash_pallas import flash_attention as flash_jax
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops.attention import (
    get_block_map, linear_attention)

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(L, H, D, seed=0, Lk=None, dtype="float32"):
    r = np.random.RandomState(seed)
    Lk = L if Lk is None else Lk
    arrs = [r.randn(1, L, H, D), r.randn(1, Lk, H, D), r.randn(1, Lk, H, D)]
    arrs = [a.astype(np.float32) for a in arrs]
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("L,bq,bk,ratio", [(1100, 512, 256, 0.4),
                                           (61, 8, 8, 0.3)])
def test_block_map_lut_matches_jax_as_sets(L, bq, bk, ratio):
    """Same top-k K-block sets per Q-block row (ties may be ordered
    differently), same sparse map and topk; both shapes end in a partial
    block."""
    (qj, kj, _), (qt, kt, _) = _qkv(L, 2, 64, seed=1)
    smap_j, lut_j, topk_j = get_block_map_jax(qj, kj, ratio, bq, bk)
    smap_t, lut_t, topk_t = get_block_map(qt, kt, ratio, bq, bk)
    assert topk_t == topk_j and lut_t.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(lut_t.numpy(), -1),
                                  np.sort(np.asarray(lut_j), -1))
    np.testing.assert_array_equal(smap_t.numpy(), np.asarray(smap_j))


@pytest.mark.parametrize("L,D,bq,bk,dtype", [
    (300, 64, 128, 128, "float32"), (300, 64, 128, 128, "bfloat16"),
    (1100, 128, 512, 256, "float32")])
def test_k3_plain_matches_jax_sparse(L, D, bq, bk, dtype):
    """K3's plain version vs the JAX LUT-gather kernel (interpret) and vs
    the masked-dense jnp reference, on the JAX block map's LUT."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(L, 2, D, seed=2, dtype=dtype)
    _, lut_j, _ = get_block_map_jax(qj, kj, 0.5, bq, bk)
    lut_t = torch.from_numpy(np.array(lut_j))
    got = fa.sparse_flash_attention(qt, kt, vt, lut_t, bq, bk).float().numpy()
    kern = flash_jax(qj, kj, vj, lut=lut_j, block_q=bq, block_k=bk,
                     interpret=True)
    np.testing.assert_allclose(got, _np(kern), atol=ATOL[dtype], rtol=0)
    if dtype == "float32":
        ref = sparse_attention_ref(qj, kj, vj, lut_j, bq, bk)
        np.testing.assert_allclose(got, _np(ref), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("L,Lk", [(300, 77), (1100, 1100)])
def test_k4_plain_matches_jax_dense(L, Lk):
    """K4's plain version vs the JAX dense flash kernel (interpret): a
    one-tile cross shape (the one-pass kernel) and a multi-tile self shape
    (the online-softmax kernel)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(L, 2, 64, seed=3, Lk=Lk)
    got = fa.flash_attention(qt, kt, vt).numpy()
    np.testing.assert_allclose(got, _np(flash_jax(qj, kj, vj, interpret=True)),
                               atol=ATOL["float32"], rtol=0)


def test_garbage_tail_rows_do_not_change_the_output():
    """Rows of K/V at or past kv_len are masked: huge garbage there changes
    nothing, and the result equals attention over the first kv_len rows."""
    kv_len, Lp, bq, bk = 1000, 1024, 512, 256
    _, (q, k, v) = _qkv(Lp, 2, 128, seed=4)
    _, lut, _ = get_block_map(q, k[:, :kv_len], 0.5, bq, bk)
    poisoned_k, poisoned_v = k.clone(), v.clone()
    poisoned_k[:, kv_len:] = 1e4
    poisoned_v[:, kv_len:] = -1e4
    short = fa.sparse_flash_attention(q, k[:, :kv_len], v[:, :kv_len], lut, bq, bk)
    for kk, vv in ((k, v), (poisoned_k, poisoned_v)):
        out = fa.sparse_flash_attention(q, kk, vv, lut, bq, bk, kv_len=kv_len)
        np.testing.assert_allclose(out.numpy(), short.numpy(), atol=1e-6)
    dense_short = fa.flash_attention(q, k[:, :kv_len], v[:, :kv_len])
    dense = fa.flash_attention(q, poisoned_k, poisoned_v, kv_len=kv_len)
    np.testing.assert_allclose(dense.numpy(), dense_short.numpy(), atol=1e-6)


def test_linear_attention_matches_jax():
    (qj, kj, vj), (qt, kt, vt) = _qkv(200, 2, 64, seed=5)
    np.testing.assert_allclose(linear_attention(qt, kt, vt).numpy(),
                               _np(linear_attention_jax(qj, kj, vj)),
                               atol=1e-5)
