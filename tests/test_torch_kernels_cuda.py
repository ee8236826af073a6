"""The port's CUDA kernels against their plain versions, on the card.

Each test needs a CUDA card (the kernels have no CPU form) and skips
without one. This file imports no jax, so it also runs where only torch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs are numpy-seeded, in bf16; shapes are small but keep the main path's
head dim (128), a ragged sequence tail and 512/256 sparse blocks. Tolerance:
bf16 atol 2e-2 plus rtol 2^-8 (one bf16 step of outputs up to ~8, where the
kernel and the plain version round an fp32 intermediate differently).
"""

import numpy as np
import pytest
import torch

from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import fused_norm as fn
from turbodiffusion_tpu_torch.ops.attention import get_block_map

ATOL, RTOL = 2e-2, 2.0 ** -8
SEQ, DIM, HEADS, DH = 528, 256, 2, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, std=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * std
    return torch.from_numpy(a).to(dev)


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine", "plain"])
def test_k1_matches_plain(dev, mode):
    x = _randn(dev, 1, SEQ, DIM).bfloat16()
    ms = _randn(dev, 1, DIM, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, DIM, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, DIM, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    before = fn._mln_cuda.launches
    got = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6)
    assert fn._mln_cuda.launches == before + 1
    _close(got, fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False])
def test_k2_matches_plain(dev, rope):
    x = _randn(dev, 1, SEQ, DIM).bfloat16()
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16()
    cos = sin = None
    if rope:
        cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 4, 66, DH, device=dev))
    before = fn._rmsrope_cuda.launches
    got = fn.rmsnorm_rope(x, w, cos, sin, num_heads=HEADS, eps=1e-5)
    assert fn._rmsrope_cuda.launches == before + 1
    want = (fn.rmsnorm_rope_ref(x, w, cos, sin, 1e-5) if rope else
            fn.rms_norm(x, w, 1e-5).reshape(got.shape))
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1100, 512, 256), (300, 128, 64)])
def test_k3_matches_plain(dev, L, bq, bk):
    q, k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (5, 6, 7))
    _, lut, _ = get_block_map(q, k, 0.5, bq, bk)
    before = fa._sparse_flash_cuda.launches
    got = fa.sparse_flash_attention(q, k, v, lut, bq, bk)
    assert fa._sparse_flash_cuda.launches == before + 1
    _close(got, fa.sparse_flash_attention_plain(q, k, v, lut, bq, bk))


@pytest.mark.cuda
@pytest.mark.parametrize("Lk", [77, 512, 1100])
def test_k4_matches_plain(dev, Lk):
    q = _randn(dev, 1, 1100, HEADS, DH, seed=8).bfloat16()
    k, v = (_randn(dev, 1, Lk, HEADS, DH, seed=s).bfloat16() for s in (9, 10))
    before = fa._flash_cuda.launches
    got = fa.flash_attention(q, k, v)
    assert fa._flash_cuda.launches == before + 1
    _close(got, fa.flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_garbage_tail_cannot_change_the_kernel_output(dev):
    """K/V rows at or past kv_len never reach the softmax in K3 or K4."""
    kv_len, Lp, bq, bk = 1000, 1024, 512, 256
    q, k, v = (_randn(dev, 1, Lp, HEADS, DH, seed=s).bfloat16() for s in (11, 12, 13))
    _, lut, _ = get_block_map(q, k[:, :kv_len], 0.5, bq, bk)
    pk, pv = k.clone(), v.clone()
    pk[:, kv_len:], pv[:, kv_len:] = 1e4, -1e4
    torch.testing.assert_close(
        fa.sparse_flash_attention(q, pk, pv, lut, bq, bk, kv_len=kv_len),
        fa.sparse_flash_attention(q, k[:, :kv_len], v[:, :kv_len], lut, bq, bk))
    torch.testing.assert_close(
        fa.flash_attention(q, pk, pv, kv_len=kv_len),
        fa.flash_attention(q, k[:, :kv_len], v[:, :kv_len]))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: an fp32 or head-dim-64 CUDA tensor raises."""
    q = _randn(dev, 1, 64, HEADS, DH)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                      # fp32
    q64 = _randn(dev, 1, 64, HEADS, 64).bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention(q64, q64, q64)                # head dim 64
    with pytest.raises(ValueError):
        fn.modulated_layer_norm(_randn(dev, 1, 8, DIM))  # fp32
