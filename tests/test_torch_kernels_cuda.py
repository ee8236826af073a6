"""The port's CUDA kernels against their plain versions, on the card.

Each test needs a CUDA card (the kernels have no CPU form) and skips
without one. This file imports no jax, so it also runs where only torch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs are numpy-seeded, in bf16; shapes are small but keep the main path's
head dim (128), a ragged sequence tail and 512/256 sparse blocks. Tolerance:
bf16 atol 2e-2 plus rtol 2^-8 (one bf16 step of outputs up to ~8, where the
kernel and the plain version round an fp32 intermediate differently); int8
outputs within 1 LSB (an fp32 value on a rounding boundary); fp32 sums rtol
1e-4 (another summation order, CUDA's expf).
"""

import numpy as np
import pytest
import torch

from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import fused_norm as fn
from turbodiffusion_tpu_torch.ops import linear_attention as la
from turbodiffusion_tpu_torch.ops import quant as qt
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
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


def _int8_close(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    assert int((got.int() - want.int()).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["q", "k", "v"])
def test_k5_matches_plain(dev, form):
    """K5's three call forms of the fused path, L = 1000 padded to 1024."""
    L, Lp = 1000, 1024
    x = _randn(dev, 1, L, DIM, seed=20).bfloat16()
    w = (1 + _randn(dev, DIM, seed=21, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 26, DH, device=dev))
    kw = {"q": dict(weight=w, cos_full=cos, sin_full=sin, pool=512,
                    quant=True, bf16_out=False),
          "k": dict(weight=w, cos_full=cos, sin_full=sin, pool=256),
          "v": dict()}[form]
    before = sf._head_planes_cuda.launches
    got = sf.head_planes(x, num_heads=HEADS, eps=1e-6, pad_to=Lp, **kw)
    assert sf._head_planes_cuda.launches == before + 1
    want = sf.head_planes_plain(x, num_heads=HEADS, eps=1e-6, pad_to=Lp, **kw)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "i8":
            _int8_close(got[key], want[key])
        elif key == "bf16":
            _close(got[key], want[key])
        else:
            torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_kv", [False, True])
def test_k6_matches_plain(dev, linear_kv):
    """Two linear-kv partial chunks (L = 3000) and a poisoned K tail that must
    stay out of the last block's statistic."""
    L, Lp, bk = 3000, 3072, 256
    k = _randn(dev, 1, HEADS, Lp, DH, seed=22).bfloat16()
    k[:, :, L:] = 1e4
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi = torch.from_numpy(np.random.RandomState(23).randint(
        -127, 128, (1, HEADS, Lp, DH)).astype(np.int8)).to(dev)
    before = sf._subquant_pack_kvt_cuda.launches
    got = sf.subquant_pack_kvt(k, mu, vi, bk, kv_len=L, linear_kv=linear_kv)
    assert sf._subquant_pack_kvt_cuda.launches == before + 1
    want = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L, linear_kv)
    _int8_close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    for g_, w_ in zip(got[3:], want[3:]):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


def _k7_operands(dev, L, Lp, bq, bk, seed):
    r = np.random.RandomState(seed)
    qi, qs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=seed))
    k = _randn(dev, 1, HEADS, Lp, DH, seed=seed + 1).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(
        _randn(dev, 1, HEADS, Lp, DH, seed=seed + 2).bfloat16(), L)
    kp, vtp, ks, kv, ksum = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L, True)
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = max(1, nK // 2)
    lut = torch.from_numpy(np.stack([r.permutation(nK)[:sel]
                                     for _ in range(HEADS * nQ)])
                           .reshape(1, HEADS, nQ, sel).astype(np.int32)).to(dev)
    lin = dict(lin_kvw=torch.matmul(kv * vcs, _randn(dev, DH, DH, seed=seed + 3,
                                                      std=0.03)),
               lin_ks_bias=torch.cat([ksum, _randn(dev, 1, HEADS, 1, DH,
                                                   seed=seed + 4, std=0.1)], 2))
    return (qi, qs, kp, vtp, ks, vcs, lut), lin


@pytest.mark.cuda
@pytest.mark.parametrize("lin", [False, True])
@pytest.mark.parametrize("L,Lp,bq,bk", [(1000, 1024, 512, 256),
                                        (520, 1024, 128, 128)])
def test_k7_matches_plain(dev, L, Lp, bq, bk, lin):
    args, lin_kw = _k7_operands(dev, L, Lp, bq, bk, seed=30)
    kw = dict(block_q=bq, block_k=bk, kv_len=L, **(lin_kw if lin else {}))
    before = si8._sparse_i8_vt_cuda.launches
    got = si8.sparse_attention_i8_vt(*args, **kw)
    assert si8._sparse_i8_vt_cuda.launches == before + 1
    _close(got, si8.sparse_attention_i8_vt_plain(*args, **kw))


@pytest.mark.cuda
def test_k7_poisoned_tail_cannot_change_live_rows(dev):
    """int8 K / V rows past kv_len set to +127 change no row before kv_len."""
    L, Lp, bq, bk = 1000, 1024, 128, 128
    (qi, qs, kp, vtp, ks, vcs, lut), _ = _k7_operands(dev, L, Lp, bq, bk, 40)
    lut = torch.arange(Lp // bk, dtype=torch.int32, device=dev).expand(
        1, HEADS, Lp // bq, Lp // bk).contiguous()
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    clean = si8.sparse_attention_i8_vt(qi, qs, kp, vtp, ks, vcs, lut, **kw)
    pk, pv = kp.clone(), vtp.clone()
    pk[:, :, L:] = 127
    pv[:, :, -1, :, L % bk:] = 127
    poisoned = si8.sparse_attention_i8_vt(qi, qs, pk, pv, ks, vcs, lut, **kw)
    assert torch.equal(clean[:, :, :L], poisoned[:, :, :L])


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: an fp32 or head-dim-64 CUDA tensor raises."""
    with pytest.raises(ValueError):
        sf.head_planes(_randn(dev, 1, 64, DIM), num_heads=HEADS)   # fp32
    with pytest.raises(ValueError):
        sf.head_planes(_randn(dev, 1, 64, 128).bfloat16(), num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 2])
def test_k2_k5_read_a_fused_qkv_column_group_in_place(dev, group):
    """K2 and K5 read Q, K or V as a column group of one (B, L, 3*D) GEMM
    output (rows 3*D apart): the same output as from a contiguous copy."""
    L, Lp = 1000, 1024
    qkv = _randn(dev, 1, L, 3 * DIM, seed=50).bfloat16()
    x = qkv.split(DIM, -1)[group]
    assert not x.is_contiguous()
    w = (1 + _randn(dev, DIM, seed=51, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 25, DH, device=dev))
    assert torch.equal(fn.rmsnorm_rope(x, w, cos, sin, num_heads=HEADS),
                       fn.rmsnorm_rope(x.contiguous(), w, cos, sin,
                                       num_heads=HEADS))
    kw = dict(weight=w, cos_full=cos, sin_full=sin, pool=256, num_heads=HEADS,
              eps=1e-6, pad_to=Lp)
    got = sf.head_planes(x, **kw)
    want = sf.head_planes(x.contiguous(), **kw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# K8-K11: the W8A8 linears (tolerances: int8 within 1 LSB, fp32 scales rtol
# 1e-5 for tanhf / torch.tanh ulps before an amax, bf16 outputs as above)
# ---------------------------------------------------------------------------

def _i8(dev, *shape, seed):
    a = np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)
    return torch.from_numpy(a).to(dev)


def _scales(dev, n, seed):
    return _randn(dev, n, seed=seed, std=0.01).abs() + 1e-3


def _scales_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,stride", [(200, 256, 256), (512, 1536, 1536),
                                        (300, 256, 768)])
def test_k8_matches_plain(dev, M, K, stride):
    """Rows of a contiguous activation and of a column group (stride 768)."""
    x = (3 * _randn(dev, M, stride, seed=60)).bfloat16()[:, :K]
    before = qt._quantize_rows_cuda.launches
    q, s = qt.quantize_rows_int8(x)
    assert qt._quantize_rows_cuda.launches == before + 1
    want_q, want_s = qt.quantize_rows_int8_plain(x)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "bias", "gelu", "gate_residual"])
def test_k9_matches_plain(dev, case):
    """M = 200 (a tail of 72 rows past the last full 128-row tile)."""
    M, K, N = 200, 512, 384
    xq, wq = _i8(dev, M, K, seed=61), _i8(dev, N, K, seed=62)
    rs, cs = _scales(dev, M, 63)[:, None], _scales(dev, N, 64)
    bias = _randn(dev, N, seed=65).bfloat16() if case != "tail" else None
    act = "gelu_tanh" if case == "gelu" else None
    gate = _randn(dev, N, seed=66) if case == "gate_residual" else None
    res = _randn(dev, M, N, seed=67).bfloat16() if case == "gate_residual" else None
    before = qt._int8_gemm_postscale_cuda.launches
    got = qt.int8_gemm_postscale(xq, rs, wq, cs, bias, act, gate, res)
    assert qt._int8_gemm_postscale_cuda.launches == before + 1
    _close(got, qt.int8_gemm_postscale_plain(xq, rs, wq, cs, bias, act, gate, res))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [768, 1536])
def test_k10_matches_plain(dev, N):
    """BN = 768 (a cluster of 6 blocks): one scale column, then two."""
    M, K = 200, 512
    xq, wq = _i8(dev, M, K, seed=70), _i8(dev, N, K, seed=71)
    rs, cs = _scales(dev, M, 72)[:, None], _scales(dev, N, 73)
    bias = _randn(dev, N, seed=74).bfloat16()
    before = qt._int8_gemm_qout_cuda.launches
    q, s = qt.int8_gemm_postscale_qout(xq, rs, wq, cs, bias, act="gelu_tanh")
    assert qt._int8_gemm_qout_cuda.launches == before + 1
    want_q, want_s = qt.int8_gemm_postscale_qout_plain(xq, rs, wq, cs, bias,
                                                       act="gelu_tanh")
    assert s.shape == (M, N // 768)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("gate_residual", [False, True])
def test_k11_matches_plain(dev, gate_residual):
    """bk = 768 over K = 1536: two slabs rescaled in order."""
    M, K, N, bk = 200, 1536, 384, 768
    xq, wq = _i8(dev, M, K, seed=80), _i8(dev, N, K, seed=81)
    xs = _randn(dev, M, K // bk, seed=82, std=0.01).abs() + 1e-3
    cs, bias = _scales(dev, N, 83), _randn(dev, N, seed=84).bfloat16()
    gate = _randn(dev, N, seed=85) if gate_residual else None
    res = _randn(dev, M, N, seed=86).bfloat16() if gate_residual else None
    before = qt._int8_gemm_blockact_cuda.launches
    got = qt.int8_gemm_blockact(xq, xs, wq, cs, bias, bk=bk, gate=gate,
                                residual=res)
    assert qt._int8_gemm_blockact_cuda.launches == before + 1
    _close(got, qt.int8_gemm_blockact_plain(xq, xs, wq, cs, bias, bk=bk,
                                            gate=gate, residual=res))


@pytest.mark.cuda
def test_w8a8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: N not a multiple of 128, K not of 64, an fp32
    activation, or an N without a scale block raises."""
    xq = _i8(dev, 64, 256, seed=90)
    s = _scales(dev, 64, 91)[:, None]
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale(xq, s, _i8(dev, 100, 256, seed=92),
                               _scales(dev, 100, 93))
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale(xq[:, :200].contiguous(), s,
                               _i8(dev, 128, 200, seed=94), _scales(dev, 128, 95))
    with pytest.raises(ValueError):
        qt.quantize_rows_int8(_randn(dev, 64, 256))
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale_qout(xq, s, _i8(dev, 256, 256, seed=96),
                                    _scales(dev, 256, 97))


# ---------------------------------------------------------------------------
# K12-K14: the int8 feeds of the W8A8 path (tolerances: int8 within 1 LSB;
# fp32 scales rtol 1e-5, K14's 5e-3 for fp32 sums in another order that move
# the bf16 rounding of a normed q or a P element)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k12_matches_plain(dev, mode):
    """norm1 / norm2 (modulated, int8 from fp32) and norm3 (affine)."""
    x = (2 * _randn(dev, 1, SEQ, DIM)).bfloat16()
    ms = _randn(dev, 1, DIM, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, DIM, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, DIM, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    before = fn._mln_quant_cuda.launches
    q, s = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6, quant_out=True)
    assert fn._mln_quant_cuda.launches == before + 1
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6, quant_out=True)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_out", [False, True])
def test_k1_k12_at_batch_2_with_the_blocks_modulation(dev, quant_out):
    """Batch 2 with the modulation as WanAttentionBlock passes it: column
    views of one (B, 6, D) tensor, which the wrapper copies to (B, D). With
    L = D, K12's scale output is the size of that copy, so it would take the
    copy's memory if the wrapper freed the copy before the launch; three
    launches in a row must each agree with the plain version."""
    x = (2 * _randn(dev, 2, DIM, DIM)).bfloat16()
    e = _randn(dev, 2, 6, DIM, seed=1, std=0.5)
    ms, mb = e[:, 1:2], e[:, 0:1]
    want = fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=quant_out)
    for _ in range(3):
        got = fn.modulated_layer_norm(x, ms, mb, eps=1e-6, quant_out=quant_out)
        if quant_out:
            _int8_close(got[0], want[0])
            _scales_close(got[1], want[1])
        else:
            _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12])
def test_k13_matches_plain_bitwise(dev, heads):
    """L = 1000 live rows of 1024-row planes: K8's rule on the unfolded
    rows, bit for bit."""
    planes = (2 * _randn(dev, 1, heads, 1024, DH, seed=100)).bfloat16()
    before = sf._unfold_quant_cuda.launches
    q, s = sf.unfold_quant(planes, 1000)
    assert sf._unfold_quant_cuda.launches == before + 1
    want_q, want_s = sf.unfold_quant_plain(planes, 1000)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,Lk", [(2, 77), (3, 512), (12, 512), (24, 77),
                                      (40, 512)])
def test_k14_matches_plain(dev, heads, Lk):
    """Clusters of 2, 3, 6 and 8 blocks: 1 or 2 heads a block on 128-row
    tiles, 3 or 5 on 64-row tiles; 77 keys mask most of the second 64-key
    chunk. Above 16 heads `cross_attention_qout` takes K17, so K14 is
    launched directly there."""
    HD = heads * DH
    q = _randn(dev, 1, 1100, HD, seed=101).bfloat16()
    k, v = (_randn(dev, 1, Lk, heads, DH, seed=s).bfloat16() for s in (102, 103))
    w = (1 + _randn(dev, HD, seed=104, std=0.2)).bfloat16()
    before = fa._cross_qout_cuda.launches
    got_q, got_s = (fa.cross_attention_qout(q, k, v, w) if heads <= 16 else
                    fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6))
    assert fa._cross_qout_cuda.launches == before + 1
    want_q, want_s = fa.cross_attention_qout_plain(q, k, v, w)
    _int8_close(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=5e-3, atol=0)


@pytest.mark.cuda
def test_int8_feed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: fp32 inputs, or 13 heads (no cluster of <= 8
    blocks with <= 5 heads each), raise."""
    with pytest.raises(ValueError):
        fn.modulated_layer_norm(_randn(dev, 1, 8, DIM), quant_out=True)
    with pytest.raises(ValueError):
        sf.unfold_quant(_randn(dev, 1, 2, 64, DH), 8)
    q13 = _randn(dev, 1, 64, 13 * DH).bfloat16()
    k13 = _randn(dev, 1, 77, 13, DH).bfloat16()
    with pytest.raises(ValueError):
        fa.cross_attention_qout(q13, k13, k13, torch.ones(13 * DH, device=dev))


# ---------------------------------------------------------------------------
# K15-K17 and the wide forms of K1, K5 and K12: the 14B's 5120-wide rows and
# 40 heads (tolerances as above; K15's fp32 sum of squares rtol 1e-5, another
# order; K16 bit for bit, the same fp32 division)
# ---------------------------------------------------------------------------

WIDE_HEADS = 40
WIDE = WIDE_HEADS * DH                            # 5120


@pytest.mark.cuda
@pytest.mark.parametrize("width,col_block", [(None, 0), (WIDE, 1)])
def test_k15_matches_plain(dev, width, col_block):
    """A 5120-wide row, and the second 5120-column block of a 15360-wide
    row read through `width` / `col_block`."""
    cols = WIDE if width is None else 3 * WIDE
    x = (2 * _randn(dev, 1, 300, cols, seed=110)).bfloat16()
    before = sf._row_rms_inv_cuda.launches
    got = sf.row_rms_inv(x, 1e-6, width=width, col_block=col_block)
    assert sf._row_rms_inv_cuda.launches == before + 1
    want = sf.row_rms_inv_plain(x, 1e-6, width=width, col_block=col_block)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["q", "k", "v"])
def test_k5_external_rms_at_40_heads_matches_plain(dev, form):
    """K5 at 40 heads, L = 1000 padded to 1024: Q and K with the row's RMS
    inverse from K15 (three head groups in one launch), V without a norm."""
    L, Lp = 1000, 1024
    x = _randn(dev, 1, L, WIDE, seed=111).bfloat16()
    w = (1 + _randn(dev, WIDE, seed=112, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 26, DH, device=dev))
    ri = sf.row_rms_inv(x, 1e-6) if form != "v" else None
    kw = {"q": dict(weight=w, cos_full=cos, sin_full=sin, pool=512,
                    quant=True, bf16_out=False),
          "k": dict(weight=w, cos_full=cos, sin_full=sin, pool=256),
          "v": dict()}[form]
    before = sf._head_planes_cuda.launches
    got = sf.head_planes(x, num_heads=WIDE_HEADS, eps=1e-6, pad_to=Lp,
                         rms_inv=ri, **kw)
    assert sf._head_planes_cuda.launches == before + 1
    want = sf.head_planes_plain(x, num_heads=WIDE_HEADS, eps=1e-6, pad_to=Lp,
                                rms_inv=ri, **kw)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "i8":
            _int8_close(got[key], want[key])
        elif key == "bf16":
            _close(got[key], want[key])
        else:
            torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=2e-2)
    with pytest.raises(ValueError):                 # 40 heads need K15's RMS
        sf.head_planes(x, w, num_heads=WIDE_HEADS, pad_to=Lp)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [33, WIDE_HEADS])
def test_k16_matches_plain_bitwise(dev, heads):
    """L = 1000 live rows of 1024-row planes at 4224 and 5120 wide: the wide
    rule y / scale, bit for bit."""
    planes = (2 * _randn(dev, 1, heads, 1024, DH, seed=113)).bfloat16()
    before = sf._unfold_quant_wide_cuda.launches
    q, s = sf.unfold_quant(planes, 1000)
    assert sf._unfold_quant_wide_cuda.launches == before + 1
    want_q, want_s = sf.unfold_quant_wide_plain(planes, 1000)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,Lk", [(24, 77), (WIDE_HEADS, 512)])
def test_k17_matches_plain(dev, heads, Lk):
    """`cross_attention_qout` above 2048 wide: K15 then K17 (clusters of 8
    blocks of 3 and of 5 heads)."""
    HD = heads * DH
    q = _randn(dev, 1, 1100, HD, seed=114).bfloat16()
    k, v = (_randn(dev, 1, Lk, heads, DH, seed=s).bfloat16() for s in (115, 116))
    w = (1 + _randn(dev, HD, seed=117, std=0.2)).bfloat16()
    before = (fa._cross_qout_wide_cuda.launches, sf._row_rms_inv_cuda.launches)
    got_q, got_s = fa.cross_attention_qout(q, k, v, w)
    assert (fa._cross_qout_wide_cuda.launches,
            sf._row_rms_inv_cuda.launches) == (before[0] + 1, before[1] + 1)
    want_q, want_s = fa.cross_attention_qout_wide_plain(
        q, sf.row_rms_inv_plain(q, 1e-6), k, v, w)
    _int8_close(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=5e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k1_k12_at_the_14b_width_match_plain(dev, mode):
    """K1 (bf16) and K12 (int8) on 5120-wide rows, ten pairs a thread."""
    x = (2 * _randn(dev, 1, SEQ, WIDE, seed=118)).bfloat16()
    ms = _randn(dev, 1, WIDE, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, WIDE, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, WIDE, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, WIDE, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    _close(fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6),
           fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6))
    before = fn._mln_quant_cuda.launches
    q, s = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6, quant_out=True)
    assert fn._mln_quant_cuda.launches == before + 1
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6, quant_out=True)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


# ---------------------------------------------------------------------------
# K18-K21: v_quant="row", --sla_block 64, the linear branch
# ---------------------------------------------------------------------------

def _row_operands(dev, L, Lp, seed):
    """K planes (non-zero mean, zero past L) and per-row int8 V."""
    k = _randn(dev, 1, HEADS, Lp, DH, seed=seed, std=2.0)
    k[:, :, L:] = 0
    k = (k + 0.5).bfloat16()
    vi, vs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=seed + 1))
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    return k, mu, vi, vs


@pytest.mark.cuda
def test_k18_matches_plain(dev):
    L, Lp = 1000, 1024
    k, mu, vi, _ = _row_operands(dev, L, Lp, 30)
    before = sf._subquant_pack_kv_cuda.launches
    kvi, ks = sf.subquant_pack_kv(k, mu, vi)
    assert sf._subquant_pack_kv_cuda.launches == before + 1
    kvi_p, ks_p = sf.subquant_pack_kv_plain(k, mu, vi)
    _int8_close(kvi, kvi_p)
    assert torch.equal(kvi[..., DH:], vi)
    torch.testing.assert_close(ks, ks_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1000, 512, 256), (300, 128, 64)])
def test_k19_matches_plain_and_ignores_a_poisoned_tail(dev, L, bq, bk):
    Lp = -(-L // 512) * 512
    k, mu, vi, vs = _row_operands(dev, L, Lp, 31)
    qi, qs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=33))
    kvi, ks = sf.subquant_pack_kv_plain(k, mu, vi)
    nQ, nK = Lp // bq, -(-L // bk)
    r = np.random.RandomState(34)
    lut = torch.from_numpy(np.stack([r.permutation(nK)[:max(1, nK // 2)]
                                     for _ in range(HEADS * nQ)])
                           .reshape(1, HEADS, nQ, -1).astype(np.int32)).to(dev)
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    before = si8._sparse_i8_planes_cuda.launches
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, ks, vs, lut, **kw)
    assert si8._sparse_i8_planes_cuda.launches == before + 1
    _close(got[:, :, :L], si8.sparse_attention_i8_planes_plain(
        qi, qs, kvi, ks, vs, lut, **kw)[:, :, :L])
    pk, pks, pvs = kvi.clone(), ks.clone(), vs.clone()
    pk[:, :, L:], pks[:, :, L:], pvs[:, :, L:] = 127, float("nan"), float("nan")
    poisoned = si8.sparse_attention_i8_planes(qi, qs, pk, pks, pvs, lut, **kw)
    assert torch.equal(poisoned[:, :, :L], got[:, :, :L])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1100, 300])
def test_k20_matches_plain(dev, L):
    q, k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (35, 36, 37))
    k = k - k.mean(dim=1, keepdim=True)
    _, lut, _ = get_block_map(q, k, 0.3, 64, 64)
    before = fa._sparse_flash_i8qk_cuda.launches
    got = fa._sparse_flash_i8qk_cuda(q, k, v, lut, 64, 64, DH ** -0.5, L)
    assert fa._sparse_flash_i8qk_cuda.launches == before + 1
    _close(got, fa.sparse_flash_attention_i8qk_plain(q, k, v, lut, 64, 64))


@pytest.mark.cuda
def test_k21_matches_plain(dev):
    """Both forms: planes with NaN rows past the true length (which stay out
    of kv / ksum) and (B, L, H, D) views read through strides."""
    L, Lp = 2500, 2560                 # two kv partial chunks
    qp, kp, vp = (_randn(dev, 1, HEADS, Lp, DH, seed=s, std=2.0).bfloat16()
                  for s in (38, 39, 40))
    w = _randn(dev, DH, DH, seed=41, std=0.05)
    b = _randn(dev, DH, seed=42, std=0.1)
    want = la.linear_projected_planes_plain(qp, kp, vp, w, b, L)
    kp[:, :, L:], vp[:, :, L:] = float("nan"), float("nan")
    before = la._linear_projected_cuda.launches
    got = la.linear_projected_planes(qp, kp, vp, w, b, L)
    assert la._linear_projected_cuda.launches == before + 1
    _close(got[:, :, :L], want[:, :, :L])
    q, k, v = (_randn(dev, 1, 700, HEADS, DH, seed=s, std=2.0).bfloat16()
               for s in (43, 44, 45))
    got = la.linear_attention_projected(q, k, v, w, b)
    assert la._linear_projected_cuda.launches == before + 2
    _close(got, la.linear_attention_projected_plain(q, k, v, w, b))


# ---------------------------------------------------------------------------
# K22: the 128x128 block-scaled W8A8 GEMM (fp32 out bit-equal to the plain
# version, which forms the same fp32 terms in the same K-block order; bf16
# out within one bf16 step, the plain version's fp32 value rounded once)
# ---------------------------------------------------------------------------

def _block_scales(dev, rows, cols, seed):
    """Scales spanning a factor of ~50 across blocks."""
    a = np.random.RandomState(seed).uniform(0, 4, (rows, cols))
    return torch.from_numpy((1e-3 * np.exp(a)).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bias,out", [
    (300, 256, 384, True, torch.float32), (300, 256, 384, False, torch.float32),
    (1000, 200, 300, True, torch.float32),        # ragged K and N: padded
    (512, 1536, 1536, True, torch.bfloat16)])
def test_k22_matches_plain(dev, M, K, N, bias, out):
    cd = lambda n: -(-n // 128)                   # noqa: E731
    xq, wq = _i8(dev, M, K, seed=100), _i8(dev, N, K, seed=101)
    xs, ws = _block_scales(dev, cd(M), cd(K), 102), _block_scales(dev, cd(N), cd(K), 103)
    b = _randn(dev, N, seed=104) if bias else None
    before = qt._int8_block_matmul_cuda.launches
    got = qt.int8_block_matmul(xq, xs, wq, ws, b, out_dtype=out)
    assert qt._int8_block_matmul_cuda.launches == before + 1
    want = qt.int8_block_matmul_plain(xq, xs, wq, ws, b, out_dtype=out)
    assert got.dtype == out and got.shape == (M, N)
    if out == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -8, atol=0)


@pytest.mark.cuda
def test_block_linear_on_the_card_matches_plain(dev):
    """An Int8BlockLinear over a (2, 200, 256) bf16 activation: the
    activation quantiser (plain torch on both devices) and K22 (bf16 out)
    against the CPU's plain composition."""
    lin = torch.nn.Linear(256, 384, dtype=torch.bfloat16)
    blk = qt.Int8BlockLinear.from_linear(lin).to(dev)
    x = (3 * _randn(dev, 2, 200, 256, seed=105)).bfloat16()
    before = qt._int8_block_matmul_cuda.launches
    got = blk(x)
    assert qt._int8_block_matmul_cuda.launches == before + 1
    want = blk.cpu()(x.cpu())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2.0 ** -8,
                               atol=0)


# ---------------------------------------------------------------------------
# K23 / K24: the block-sparse attention backward (dq pass, inverse-LUT dk/dv
# pass). lse and delta are fp32 (atol 1e-4 + rtol 1e-5: another summation
# order, exp2 against exp); the gradients bf16 (ATOL / RTOL).
# ---------------------------------------------------------------------------

def _bwd_operands(dev, L, bq, bk, seed):
    """q, k, v, dO (1, L, HEADS, 128) bf16 views into buffers whose rows past
    L hold NaN, and a LUT that never selects the last K-block but one."""
    bufs = []
    for s in range(4):
        t = _randn(dev, 1, L + 64, HEADS, DH, seed=seed + s).bfloat16()
        t[:, L:] = float("nan")
        bufs.append(t[:, :L])
    nQ, nK = -(-L // bq), -(-L // bk)
    r = np.random.RandomState(seed + 4)
    keep = [j for j in range(nK) if j != nK - 2]
    sel = max(1, len(keep) // 2)
    lut = np.stack([r.permutation(keep)[:sel] for _ in range(HEADS * nQ)])
    lut = torch.from_numpy(lut.reshape(1, HEADS, nQ, sel).astype(np.int32))
    return (*bufs, lut.to(dev), nQ, nK)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1100, 512, 256), (520, 128, 128)])
def test_k23_k24_match_plain(dev, L, bq, bk):
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    q, k, v, do, lut, nQ, nK = _bwd_operands(dev, L, bq, bk, 50)
    scale = DH ** -0.5
    b23, b24 = sb._sparse_bwd_dq_cuda.launches, sb._sparse_bwd_dkv_cuda.launches
    dq, ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk, scale, L)
    dq_p, ld_p = sb.sparse_bwd_dq_plain(q, k, v, do, lut, bq, bk, scale, L)
    _close(dq, dq_p)
    torch.testing.assert_close(ld[:, :L], ld_p[:, :L], atol=1e-4, rtol=1e-5)
    inv = sb.inverse_lut(lut, nK)
    poisoned = ld.clone()
    poisoned[:, L:] = float("nan")           # rows past L are never read
    dk, dv = sb._sparse_bwd_dkv_cuda(q, k, v, do, poisoned, inv, bq, bk, scale, L)
    dk_p, dv_p = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, bq, bk, scale, L)
    _close(dk, dk_p)
    _close(dv, dv_p)
    assert sb._sparse_bwd_dq_cuda.launches == b23 + 1
    assert sb._sparse_bwd_dkv_cuda.launches == b24 + 1
    # the never-selected K-block: exactly zero; a second run: the same bits
    blk = slice((nK - 2) * bk, (nK - 1) * bk)
    assert not dk[:, blk].any() and not dv[:, blk].any()
    dk2, dv2 = sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, bq, bk, scale, L)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk,
                                                  scale, L)[0])


@pytest.mark.cuda
def test_sparse_attention_autograd_on_the_card_matches_cpu(dev):
    """K3's autograd Function: the card's gradients (K23 + K24, dO strided
    as autograd hands it over) against the plain versions' on the CPU."""
    L, bq, bk = 1100, 512, 256
    q, k, v, _, lut, _, _ = _bwd_operands(dev, L, bq, bk, 60)
    g = _randn(dev, 1, HEADS, L, DH, seed=65).bfloat16().transpose(1, 2)

    def grads(q, k, v, lut, g):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = fa.sparse_flash_attention(q, k, v, lut, bq, bk)
        return (o, *torch.autograd.grad(o, (q, k, v), g))

    got = grads(q, k, v, lut, g)
    want = grads(*(t.cpu() for t in (q, k, v, lut, g)))
    for a, b in zip(got, want):
        _close(a.cpu(), b)


@pytest.mark.cuda
def test_k23_k24_refuse_what_they_do_not_take(dev):
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    q = _randn(dev, 1, 256, HEADS, 64).bfloat16()
    lut = torch.zeros(1, HEADS, 2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim 128"):
        sb.sparse_flash_attention_bwd(q, q, q, q, lut, 128, 128)
    q = _randn(dev, 1, 256, HEADS, DH).bfloat16()
    with pytest.raises(ValueError, match="multiples of 64"):
        sb.sparse_flash_attention_bwd(q, q, q, q, lut[:, :, :1], 256, 32)


# ---------------------------------------------------------------------------
# K25 / K26: forward-mode (JVP) attention, dense and block-sparse. q has std
# 3 and the tangents the size of the primals, so that mu, P dv and each term
# of dS matter: the planted faults (mu dropped, P dv dropped, q dk^T dropped
# from dS, a LUT entry dropped; errors of 3 and more) must each fail the
# comparison. o at ATOL / RTOL; do at atol 2e-2 + rtol 2e-2, chip_smoke's
# bf16 tolerance: do = acc_t / l - mu o subtracts terms of up to ~10 whose
# bf16-rounded P dS the kernel rounds at the running max of the online
# softmax and the plain version at the row's final max, which leaves a few
# elements a bf16 step (2^-5 at 4 to 8) apart.
# ---------------------------------------------------------------------------

def _close_do(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _jvp_operands(dev, L, Lk, seed):
    """q, k, v, dq, dk, dv (1, L or Lk, HEADS, 128) bf16 views into buffers
    whose rows past their length hold NaN."""
    out = []
    for i, (n, std) in enumerate(((L, 3.0), (Lk, 1.0), (Lk, 1.0), (L, 1.0),
                                  (Lk, 1.0), (Lk, 1.0))):
        t = _randn(dev, 1, n + 64, HEADS, DH, seed=seed + i, std=std).bfloat16()
        t[:, n:] = float("nan")
        out.append(t[:, :n])
    return out


def _mu_hat(q, k, dq, dk, kv_len, lut=None, bq=None, bk=None):
    """rowsum(softmax(S) dS), (1, L, HEADS, 1) fp32: what do subtracts times
    o. Dense, or over the K-blocks the LUT selects."""
    scale = DH ** -0.5
    qh, kh, dqh, dkh = (t.float().transpose(1, 2) for t in (q, k, dq, dk))
    s = qh @ kh.transpose(-1, -2) * scale
    ds = (dqh @ kh.transpose(-1, -2) + qh @ dkh.transpose(-1, -2)) * scale
    cols = torch.arange(k.shape[1], device=q.device)
    live = (cols < kv_len).expand(s.shape)
    if lut is not None:
        allowed = torch.zeros((*lut.shape[:3], -(-k.shape[1] // bk)),
                              dtype=torch.bool, device=q.device)
        allowed.scatter_(-1, lut.long(), True)
        rows = torch.arange(q.shape[1], device=q.device) // bq
        live = live & allowed[:, :, rows][..., cols // bk]
    p = torch.softmax(torch.where(live, s, -1e30), -1)
    return (p * torch.where(live, ds, 0.0)).sum(-1, keepdim=True).transpose(1, 2)


def _rejects(bad, want):
    with pytest.raises(AssertionError):
        _close_do(bad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,Lk", [(1100, 1100), (300, 77)])
def test_k25_matches_plain_and_rejects_planted_faults(dev, L, Lk):
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    q, k, v, dq, dk, dv = _jvp_operands(dev, L, Lk, 70)
    scale = DH ** -0.5
    before = fj._flash_jvp_cuda.launches
    o, do = fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, Lk)
    assert fj._flash_jvp_cuda.launches == before + 1
    o_p, do_p = fj.flash_attention_jvp_plain(q, k, v, dq, dk, dv, scale, Lk)
    _close(o, o_p)
    _close_do(do, do_p)
    zero = torch.zeros_like
    _rejects(do.float() + _mu_hat(q, k, dq, dk, Lk) * o.float(), do_p)
    _rejects(fj._flash_jvp_cuda(q, k, v, dq, dk, zero(dv), scale, Lk)[1], do_p)
    _rejects(fj._flash_jvp_cuda(q, k, v, dq, zero(dk), dv, scale, Lk)[1], do_p)
    o2, do2 = fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, Lk)
    assert torch.equal(o, o2) and torch.equal(do, do2)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1100, 512, 256), (520, 128, 128)])
def test_k26_matches_plain_and_rejects_planted_faults(dev, L, bq, bk):
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    q, k, v, dq, dk, dv = _jvp_operands(dev, L, L, 80)
    lut = _bwd_operands(dev, L, bq, bk, 90)[4]
    scale = DH ** -0.5
    before = fj._sparse_flash_jvp_cuda.launches
    o, do = fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut, bq, bk, scale, L)
    assert fj._sparse_flash_jvp_cuda.launches == before + 1
    o_p, do_p = fj.sparse_flash_attention_jvp_plain(q, k, v, dq, dk, dv, lut,
                                                    bq, bk, scale, L)
    _close(o, o_p)
    _close_do(do, do_p)
    zero = torch.zeros_like
    args = (lut, bq, bk, scale, L)
    mu = _mu_hat(q, k, dq, dk, L, lut, bq, bk)
    _rejects(do.float() + mu * o.float(), do_p)
    _rejects(fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, zero(dv), *args)[1], do_p)
    _rejects(fj._sparse_flash_jvp_cuda(q, k, v, dq, zero(dk), dv, *args)[1], do_p)
    dropped = fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut[..., :-1],
                                        *args[1:])
    _rejects(dropped[0], o_p)
    o2, do2 = fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, *args)
    assert torch.equal(o, o2) and torch.equal(do, do2)


@pytest.mark.cuda
def test_jvp_wrappers_on_the_card_launch_one_kernel(dev):
    """Under forward AD a dense call launches one K25 and no K4, a sparse
    call one K26 and no K3; (o, do) equal the card's kernel outputs."""
    import torch.autograd.forward_ad as fwAD
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    L, bq, bk = 1100, 512, 256
    q, k, v, dq, dk, dv = _jvp_operands(dev, L, L, 100)
    lut = _bwd_operands(dev, L, bq, bk, 110)[4]
    counters = (fa._flash_cuda, fa._sparse_flash_cuda, fj._flash_jvp_cuda,
                fj._sparse_flash_jvp_cuda)
    before = [c.launches for c in counters]
    with torch.no_grad(), fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in ((q, dq), (k, dk), (v, dv))]
        dense = fwAD.unpack_dual(fj.flash_attention_jvp(*duals))
        sparse = fwAD.unpack_dual(fj.sparse_attention_jvp(*duals, lut, bq, bk))
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1, 1]
    scale = DH ** -0.5
    for got, want in ((dense, fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, L)),
                      (sparse, fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut,
                                                         bq, bk, scale, L))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
