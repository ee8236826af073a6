"""The fused SageSLA path of the PyTorch port against the JAX package.

K5 (head_planes), K6 (subquant_pack_kvt) and K7 (sparse_attention_i8_vt)
take their plain versions on CPU tensors; the JAX kernels run in interpret
mode. Inputs are numpy-seeded, at L = 520 (a ragged tail: Lp = 1024) and
1,024, H = 2, Dh = 128, blocks 128 and 512/256. Tolerances, with reasons:
  * K5 against the JAX kernel: int8 at most 1 LSB, fp32 scales within one
    bf16 step (rtol 2^-7), bf16 planes within one bf16 step of the plane's
    largest value (RoPE sums cancel, so a relative bound is meaningless),
    pooled means atol 4e-3 on values ~1. In interpret mode on the CPU, XLA's excess precision skips
    the bf16 rounding of the RMSNorm weight product that the reference
    chain (`head_planes_ref`, K2) keeps; the port keeps it, so its bf16
    planes equal `head_planes_ref` exactly;
  * other int8 outputs: at most 1 LSB; fp32 scales rtol 1e-6 and sums
    rtol 1e-5 (fp32 sums in another order);
  * attention outputs: atol 2e-2 on values ~1 (bf16 output and the bf16
    rounding of p; the plain version keeps the one-pass softmax of JAX);
  * the whole DiT forward in bf16: atol 2e-2 on velocities up to ~3.5
    (bf16 GEMMs of two libraries, compounded over two blocks; 0.008 seen).
LUT rows are compared as sets: `torch.topk` may order ties differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.ops import sla_fused as sf_jax
from turbodiffusion_tpu.ops.attention import (
    sla_attention_fused as sla_attention_fused_jax)
from turbodiffusion_tpu.ops.flash_pallas import (
    quantize_v_per_channel as quantize_v_jax,
    sparse_attention_i8_vt as sparse_i8_vt_jax)
from turbodiffusion_tpu_torch.config import AttentionConfig
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
from turbodiffusion_tpu_torch.ops.attention import sla_attention_fused
from turbodiffusion_tpu_torch.ops.fused_norm import rope_cos_sin_full

H, DH = 2, 128
HD = H * DH
EPS = 1e-6
BF16_RTOL = 2.0 ** -7          # one bf16 step (7 stored mantissa bits)


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _tables(L):
    """rotate-half tables of a (5, 8, 26) grid (1,040 rows) cut to L rows,
    and padded to Lp for the JAX kernel (its BlockSpec reads Lp rows)."""
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(5, 8, 26, DH))
    cosF, sinF = cosF[:L], sinF[:L]
    Lp = -(-L // 512) * 512
    pad = ((0, Lp - L), (0, 0))
    return (cosF, sinF), (jnp.asarray(np.pad(cosF.numpy(), pad)),
                          jnp.asarray(np.pad(sinF.numpy(), pad)))


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

# (name, norm + rope, pool, quant, bf16 plane): the fused path's three calls
HEAD_PLANES_FORMS = [("q", True, 128, True, False),
                     ("q", True, 256, True, False),
                     ("k", True, 256, False, True),
                     ("k", True, 128, False, True),
                     ("v", False, 0, False, True),
                     ("all", True, 128, True, True)]


@pytest.mark.parametrize("L", [520, 1024])
@pytest.mark.parametrize("form,rope,pool,quant,bf16_out", HEAD_PLANES_FORMS)
def test_k5_plain_matches_jax(L, form, rope, pool, quant, bf16_out):
    Lp = -(-L // 512) * 512
    xj, xt = _bf16(_rand((1, L, HD), 1))
    wj, wt = _bf16(1 + _rand((HD,), 2, 0.1))
    (ct, st), (cj, sj) = _tables(L)
    kw = dict(num_heads=H, eps=EPS, pool=pool, quant=quant, bf16_out=bf16_out,
              pad_to=Lp)
    want = sf_jax.head_planes(xj, wj if rope else None, cj if rope else None,
                              sj if rope else None, interpret=True, **kw)
    got = sf.head_planes(xt, wt if rope else None, ct if rope else None,
                         st if rope else None, **kw)
    assert sorted(got) == sorted(want)
    if bf16_out:
        assert got["bf16"].shape == (1, H, Lp, DH)
        w16 = _np(want["bf16"])[:, :, :L]
        np.testing.assert_allclose(_np(got["bf16"])[:, :, :L], w16, rtol=0,
                                   atol=BF16_RTOL * np.abs(w16).max())
        assert not got["bf16"][:, :, L:].any()          # zero tail
        ref = sf_jax.head_planes_ref(xj, wj if rope else None,
                                     cj if rope else None,
                                     sj if rope else None, num_heads=H,
                                     eps=EPS)["bf16"]
        np.testing.assert_array_equal(_np(got["bf16"])[:, :, :L], _np(ref))
    if quant:
        _int8_close(got["i8"][:, :, :L].numpy(), np.asarray(want["i8"])[:, :, :L])
        np.testing.assert_allclose(got["scale"][:, :, :L].numpy(),
                                   np.asarray(want["scale"])[:, :, :L],
                                   rtol=BF16_RTOL)
    if pool:
        assert got["pooled"].shape == (1, H, -(-L // pool), DH)
        np.testing.assert_allclose(got["pooled"].numpy(),
                                   np.asarray(want["pooled"]), atol=4e-3)


# which form a K5 launch takes: pointers as numbers (16-byte aligned BASE,
# the fused QKV K group 3072 bytes in, 2 bytes off), row strides; ptrs are
# x, weight, cos, sin, bf16 planes, int8 planes, partials
BASE = 1 << 20
K5_FORMS = [
    ((12, 1536, BASE, BASE), "vector"),             # 1.3B q / k / v
    ((12, 4608, BASE + 3072, BASE), "vector"),      # its fused QKV K group
    ((40, 5120, BASE, BASE), "vector"),             # 14B, the RMS in the row
    ((64, 8192, BASE, BASE), "vector"),             # the widest row
    ((1, 128, BASE, BASE), "vector"),
    ((65, 8320, BASE, BASE), "refused"),            # above 8192
    ((12, 1540, BASE, BASE), "refused"),            # row stride off 8
    ((12, 1528, BASE, BASE), "refused"),            # stride under the row
    ((12, 1536, BASE + 2, BASE), "refused"),        # unaligned view
    ((12, 1536, BASE, BASE + 4), "refused"),        # unaligned weight / table
]


@pytest.mark.parametrize("args,form", K5_FORMS,
                         ids=[f"{a[0]}h-ld{a[1]}-x{a[2] - BASE}-o{a[3] - BASE}"
                              for a, _ in K5_FORMS])
def test_head_planes_form_by_shape(args, form):
    """K5's warp-per-row kernel takes 1-64 heads of 128 with the RMS taken
    in the row at every width, row strides that are multiples of 8 and at
    least the row, and aligned pointers; the C entry refuses the rest.
    Absent outputs (None) do not change the form."""
    H, ld, x, other = args
    assert sf.head_planes_form(H, ld, x, other, BASE, BASE, BASE, None, BASE) == form
    assert sf.head_planes_form(H, ld, x, None, None, None, None, BASE, None) == (
        form if other == BASE else "vector")
    assert sf.head_planes_form(H, ld, None, BASE, BASE, BASE, BASE, BASE, BASE) == "refused"


def test_head_planes_form_limits_match_the_kernel_source():
    """The widest row and the tile the wrapper assumes are the CUDA
    source's: kMaxHeads = kMaxVecRow / 128 heads (csrc/warp_rows.cuh's
    8 x 32 lanes x row warps x vectors a lane) and 64-row tiles."""
    import re
    from pathlib import Path
    csrc = Path(sf.__file__).resolve().parent.parent / "csrc"
    rows = (csrc / "warp_rows.cuh").read_text()
    src = (csrc / "sla_fused.cu").read_text()
    vpl = int(re.search(r"constexpr int kMaxVpl = (\d+);", rows).group(1))
    warps = int(re.search(r"constexpr int kMaxRowWarps = (\d+);", rows).group(1))
    assert "constexpr int kMaxHeads = kMaxVecRow / kDh;" in src
    assert 8 * 32 * warps * vpl // DH == sf._HP_MAX_HEADS
    assert int(re.search(r"constexpr int kHpRows = (\d+);", src).group(1)) == sf._HP_ROWS


WIDE_H = 40                                        # the 14B's heads


@pytest.mark.parametrize("form,pool,quant,bf16_out", [("q", 128, True, False),
                                                      ("k", 256, False, True)])
def test_k5_in_row_rms_at_40_heads_matches_jax_fed_row_rms_inv(form, pool, quant,
                                                               bf16_out):
    """The 14B's Q and K passes take the row's RMS in K5 (no K15 launch):
    the port's `head_planes` without `rms_inv`, 40 heads, L = 256 padded to
    512, against JAX's `head_planes` fed `row_rms_inv` (its wide
    composition), at K5's tolerances."""
    L, Lp, hd = 256, 512, WIDE_H * DH
    xj, xt = _bf16(_rand((1, L, hd), 31))
    wj, wt = _bf16(1 + _rand((hd,), 32, 0.1))
    (ct, st), (cj, sj) = _tables(L)
    kw = dict(num_heads=WIDE_H, eps=EPS, pool=pool, quant=quant,
              bf16_out=bf16_out, pad_to=Lp)
    ri = sf_jax.row_rms_inv(xj, EPS, interpret=True)
    want = sf_jax.head_planes(xj, wj, cj, sj, interpret=True,
                              rms_inv=jnp.pad(ri, ((0, 0), (0, Lp - L), (0, 0))), **kw)
    got = sf.head_planes(xt, wt, ct, st, **kw)
    assert sorted(got) == sorted(want)
    if bf16_out:
        w16 = _np(want["bf16"])[:, :, :L]
        np.testing.assert_allclose(_np(got["bf16"])[:, :, :L], w16, rtol=0,
                                   atol=BF16_RTOL * np.abs(w16).max())
    if quant:
        _int8_close(got["i8"][:, :, :L].numpy(), np.asarray(want["i8"])[:, :, :L])
        np.testing.assert_allclose(got["scale"][:, :, :L].numpy(),
                                   np.asarray(want["scale"])[:, :, :L], rtol=BF16_RTOL)
    assert got["pooled"].shape == (1, WIDE_H, L // pool, DH)
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]),
                               atol=4e-3)


def test_fused_path_at_the_14b_width_takes_the_rms_in_k5(monkeypatch):
    """`sla_attention_fused` at 40 heads of 128 calls K5 three times with
    no external RMS and never K15 (`row_rms_inv`), where JAX's wide
    composition takes `row_rms_inv` on Q and K first."""
    from turbodiffusion_tpu_torch.ops import attention as attention_port
    L, hd = 256, WIDE_H * DH
    xs = [torch.from_numpy(_rand((1, L, hd), s)).bfloat16() for s in (33, 34, 35)]
    wq, wk = (torch.from_numpy(1 + _rand((hd,), s, 0.1)).bfloat16() for s in (36, 37))
    (ct, st), _ = _tables(L)
    rms_inv, k15 = [], []

    def spy_k5(*a, **k):
        rms_inv.append(k.get("rms_inv"))
        return sf.head_planes(*a, **k)

    def spy_k15(*a, **k):
        k15.append(1)
        return sf.row_rms_inv(*a, **k)

    monkeypatch.setattr(attention_port, "head_planes", spy_k5)
    monkeypatch.setattr(sf, "row_rms_inv", spy_k15)
    cfg = AttentionConfig(backend="sagesla", sla_topk=0.5, block_q=128, block_k=128,
                          linear_branch=False, v_quant="channel")
    with torch.no_grad():
        o = sla_attention_fused(*xs, wq, wk, (ct, st), None, cfg, num_heads=WIDE_H,
                                eps=EPS)
    assert o.shape == (1, WIDE_H, 512, DH) and bool(o.float().isfinite().all())
    assert rms_inv == [None, None, None] and not k15


@pytest.mark.parametrize("L", [520, 1024, 1500])
def test_q_pooled_at_block_q_equals_the_jax_merge(L):
    """The port pools Q at block_q = 512 directly; JAX pools at 256 and merges
    pairs weighted by count (attention.py:429-440). The JAX merge, applied
    to the port's 256-row means (held against the JAX kernel above), equals
    the port's 512-row means. L = 520 leaves the second 512-block 8 valid
    rows and an odd number of 256-blocks."""
    Lp = -(-L // 512) * 512
    _, xt = _bf16(_rand((1, L, HD), 3))
    _, wt = _bf16(1 + _rand((HD,), 4, 0.1))
    (ct, st), _ = _tables(L) if L <= 1040 else _long_tables(L)
    kw = dict(num_heads=H, eps=EPS, quant=True, bf16_out=False, pad_to=Lp)
    p256 = jnp.asarray(sf.head_planes(xt, wt, ct, st, pool=256,
                                      **kw)["pooled"].numpy())
    # the merge of _sla_attention_fused_impl, block_q 512 over q_pool 256
    f, nP = 2, p256.shape[2]
    nPp = -(-nP // f) * f
    cnt = jnp.clip(L - jnp.arange(nPp) * 256, 0, 256).astype(jnp.float32)
    pq = jnp.pad(p256, ((0, 0), (0, 0), (0, nPp - nP), (0, 0)))
    pq = (pq * cnt[None, None, :, None]).reshape(1, H, nPp // f, f, DH).sum(3)
    merged = pq / jnp.maximum(cnt.reshape(nPp // f, f).sum(1), 1.0)[
        None, None, :, None]
    got = sf.head_planes(xt, wt, ct, st, pool=512, **kw)["pooled"]
    assert got.shape == merged.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(merged), rtol=1e-5,
                               atol=1e-5)


def _long_tables(L):
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(5, 20, 30, DH))
    Lp = -(-L // 512) * 512
    cosF, sinF = cosF[:L], sinF[:L]
    pad = ((0, Lp - L), (0, 0))
    return (cosF, sinF), (jnp.asarray(np.pad(cosF.numpy(), pad)),
                          jnp.asarray(np.pad(sinF.numpy(), pad)))


# ---------------------------------------------------------------------------
# block map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,bq,bk,ratio", [(520, 128, 128, 0.5),
                                           (1024, 512, 256, 0.5),
                                           (32760, 512, 256, 0.1)])
def test_block_map_from_pooled_matches_jax(L, bq, bk, ratio):
    nQ, nK = -(-L // bq), -(-L // bk)
    pq = _rand((1, H, nQ, DH), 5)
    pk = _rand((1, H, nK, DH), 6) + _rand((1, H, 1, DH), 7)
    lut_j, topk_j, mean_j = sf_jax.block_map_from_pooled(
        jnp.asarray(pq), jnp.asarray(pk), L, bk, ratio)
    lut_t, topk_t, mean_t = sf.block_map_from_pooled(
        torch.from_numpy(pq), torch.from_numpy(pk), L, bk, ratio)
    assert topk_t == topk_j and lut_t.dtype == torch.int32
    assert lut_t.shape == (1, H, nQ, topk_j)
    np.testing.assert_array_equal(np.sort(lut_t.numpy(), -1),
                                  np.sort(np.asarray(lut_j), -1))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# K6 and the per-channel V quantisation
# ---------------------------------------------------------------------------

def _k_and_v(L, Lp, seed):
    """K planes with a non-zero mean and per-channel int8 V, zero past L (as
    K5 leaves them)."""
    k = np.zeros((1, H, Lp, DH), np.float32)
    k[:, :, :L] = _rand((1, H, L, DH), seed) + _rand((1, H, 1, DH), seed + 1)
    v = np.zeros((1, H, Lp, DH), np.float32)
    v[:, :, :L] = _rand((1, H, L, DH), seed + 2)
    return k, v


@pytest.mark.parametrize("L", [520, 1024])
def test_quantize_v_per_channel_matches_jax(L):
    Lp = -(-L // 512) * 512
    _, v = _k_and_v(L, Lp, 8)
    v[:, :, L:] = 50.0                        # garbage rows stay out of amax
    vj, vt = _bf16(v)
    qi_j, sc_j = quantize_v_jax(vj, L)
    qi_t, sc_t = si8.quantize_v_per_channel(vt, L)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6)
    _int8_close(qi_t[:, :, :L].numpy(), np.asarray(qi_j)[:, :, :L])


@pytest.mark.parametrize("linear_kv", [False, True])
@pytest.mark.parametrize("L,bk", [(520, 128), (1024, 256), (520, 256)])
def test_k6_plain_matches_jax(L, bk, linear_kv):
    Lp = -(-L // 512) * 512
    k, v = _k_and_v(L, Lp, 9)
    kj, kt = _bf16(k)
    mu = (k[:, :, :L].mean(2, keepdims=True)).astype(np.float32)
    vi_j, _ = quantize_v_jax(jnp.asarray(v, jnp.bfloat16), L)
    vi = np.asarray(vi_j)
    want = sf_jax.subquant_pack_kvt(kj, jnp.asarray(mu), vi_j, bk, kv_len=L,
                                    linear_kv=linear_kv, interpret=True)
    got = sf.subquant_pack_kvt(kt, torch.from_numpy(mu), torch.from_numpy(vi),
                               bk, kv_len=L, linear_kv=linear_kv)
    assert len(got) == len(want) == (5 if linear_kv else 3)
    _int8_close(got[0][:, :, :L].numpy(), np.asarray(want[0])[:, :, :L])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)
    if linear_kv:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=1e-5, atol=1e-5)


# K6's runs with the linear branch: (B, H, nK, resident blocks) -> the
# blocks the launch takes; the 1.3B and 14B 480p shapes at 256-row blocks
# on 132 SMs (the 14B's in two waves of runs of 19-20 K blocks), batch 2,
# 720p, more heads than resident blocks (a block a head at least), fewer K
# blocks than resident blocks (a block a K block)
KVT_GRIDS = [((1, 12, 128, 132), 132), ((1, 40, 128, 132), 264), ((2, 40, 128, 132), 528),
             ((1, 40, 296, 132), 528), ((4, 40, 8, 132), 160), ((4, 40, 2, 132), 160),
             ((1, 2, 4, 132), 8), ((1, 12, 12, 132), 132), ((1, 12, 48, 0), 24)]


@pytest.mark.parametrize("shape,grid", KVT_GRIDS,
                         ids=[f"{b}x{h}x{n}-{r}" for (b, h, n, r), _ in KVT_GRIDS])
def test_kvt_runs_by_shape(shape, grid):
    """K6 takes one block a resident slot (with the linear branch, in as
    many waves as keep each run to `_KVT_MAX_RUN` K blocks; without it, one
    wave), at least one a (b, h) and at most one a K block; its runs split
    the flat (b, h, K block) order evenly (`k6::run_start`: floor(i total /
    grid)), cover every K block once and span at most two heads; each
    head's partials are listed in run order, slot 0 for a run's first head,
    and `k6::run_of` finds a block's run."""
    B, H, nK, resident = shape
    assert sf.kvt_grid(B, H, nK * 256, 256, resident) == grid
    total = B * H * nK
    assert sf.kvt_grid(B, H, nK * 256, 256, resident, linear_kv=False) == min(
        total, max(resident, 1, B * H))
    runs = sf.kvt_runs(total, grid)
    assert runs[0][0] == 0 and runs[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert max(e - a for a, e in runs) - min(e - a for a, e in runs) <= 1
    assert max(e - a for a, e in runs) <= sf._KVT_MAX_RUN or grid == B * H
    for i, (a, e) in enumerate(runs):
        assert (e - 1) // nK - a // nK <= 1
        for blk in (a, e - 1):
            assert ((blk + 1) * grid - 1) // total == i          # run_of
    parts = sf.kvt_partials(B, H, nK, grid)
    for bh, plist in enumerate(parts):
        cta = [i for i, _ in plist]
        assert cta == sorted(cta) and len(set(cta)) == len(cta)
        rows = sum(min(runs[i][1], (bh + 1) * nK) - max(runs[i][0], bh * nK) for i in cta)
        assert rows == nK
        for i, slot in plist:
            assert slot == (0 if runs[i][0] // nK == bh else 1)


@pytest.mark.parametrize("heads", [12, 40])
def test_kvt_runs_at_480p_stay_within_the_longest_run(heads):
    """At the 1.3B and 14B 480p shapes (32,768 rows a head, 256-row blocks,
    132 SMs) every run of K6's walk with the linear branch sums at most
    `_KVT_MAX_RUN` K blocks (the run length bounds the rounding of its fp32
    kv sums) and spans at most two heads."""
    nK = 32768 // 256
    grid = sf.kvt_grid(1, heads, 32768, 256, 132)
    runs = sf.kvt_runs(heads * nK, grid)
    assert max(e - a for a, e in runs) <= sf._KVT_MAX_RUN
    assert all((e - 1) // nK - a // nK <= 1 for a, e in runs)


def test_kvt_constants_match_the_kernel_source():
    """The largest block, a partial's floats, the longest run, the grid,
    the run split and the slot rule the wrapper assumes are the CUDA
    source's (`k6::` and the `linear_kv.cuh` it shares with K21); K16's widest
    row is 20 vectors of 8 values a lane of a warp."""
    import re
    from pathlib import Path
    src = (Path(sf.__file__).resolve().parent.parent / "csrc" / "sla_fused.cu").read_text()
    # K6's namespace and what it takes from the header it shares with K21
    k6 = (src[src.index("namespace k6 {"):src.index("}  // namespace k6")]
          + (Path(sf.__file__).resolve().parent.parent / "csrc" / "linear_kv.cuh").read_text())
    assert int(re.search(r"constexpr int kMaxBlockK = (\d+);", k6).group(1)) == sf._KVT_MAX_BLOCK
    assert "constexpr int kSlot = (kDh + 1) * kDh;" in k6 and sf._KVT_SLOT == 129 * 128
    assert "return (int)((long long)i * total / grid);" in k6
    assert "return (int)(((long long)(blk + 1) * grid - 1) / total);" in k6
    assert "const int slot = run_start(i, total, grid) / n == bh ? 0 : 1;" in k6
    assert "linkv::reduce_partials(part, kv, ksum, nK, total, grid);" in k6
    assert int(re.search(r"constexpr int kMaxRun = (\d+);", k6).group(1)) == sf._KVT_MAX_RUN
    assert ("const int waves = LINEAR ? (total + resident * kMaxRun - 1) / "
            "(resident * kMaxRun) : 1;") in k6
    assert "return std::min(total, std::max(resident * waves, B * H));" in k6
    chunks = int(re.search(r"constexpr int kUqWideChunks = (\d+);", src).group(1))
    assert chunks * 32 * 8 == sf._UNFOLD_WIDE_MAX
    assert int(re.search(r"constexpr int kWideRowWarps = (\d+);", src).group(1)) in (1, 2, 4)


def _kv_split_emulation(k, vi, L, split):
    """K6's kv / ksum arithmetic in plain torch (fp32 arithmetic is
    IEEE's on the CPU, the tensor core's sums are exact here): phi in fp32
    (zero rows past L), each 32-row step's product from phi's two halves,
    hi = round(2^8 phi) and lo = round(2^8 phi - hi) in `split` (fp16 as the
    kernel; bf16 as a plain split would), exact against the int8 V, summed
    a step at a time in fp32, then times 2^-8."""
    B, Hh, Lp, D = k.shape
    valid = (torch.arange(Lp) < L)[:, None]
    phi = torch.where(valid, sf._softmax_d(k.float()), 0.0) * 256.0
    hi = phi.to(split).float()
    lo = (phi - hi).to(split).float()
    kv = torch.zeros(B, Hh, D, D)
    for r0 in range(0, Lp, 32):
        step = torch.matmul(hi[:, :, r0:r0 + 32].double().transpose(-1, -2),
                            vi[:, :, r0:r0 + 32].double())
        step += torch.matmul(lo[:, :, r0:r0 + 32].double().transpose(-1, -2),
                             vi[:, :, r0:r0 + 32].double())
        kv = kv + step.float()
    return kv / 256.0, (phi.sum(2, keepdim=True) / 256.0)


@pytest.mark.parametrize("L", [1000, 520])
def test_kv_split_emulation_matches_plain_and_jax(L):
    """K6's fp16 hi / lo split of 2^8 phi, emulated, lies within the card
    tests' rtol 1e-4 / atol 1e-4 of the plain version and of JAX's kernel
    in interpret mode; a bf16 split (~2^-17 of phi) lies farther from the
    float64 sums."""
    Lp, bk = 1024, 256
    k, v = _k_and_v(L, Lp, 17)
    kj, kt = _bf16(k)
    mu = (k[:, :, :L].mean(2, keepdims=True)).astype(np.float32)
    vi_j, _ = quantize_v_jax(jnp.asarray(v, jnp.bfloat16), L)
    vi = torch.from_numpy(np.array(vi_j))
    kv16, ks16 = _kv_split_emulation(kt, vi, L, torch.float16)
    plain = sf.subquant_pack_kvt_plain(kt, torch.from_numpy(mu), vi, bk, L, linear_kv=True)
    want = sf_jax.subquant_pack_kvt(kj, jnp.asarray(mu), vi_j, bk, kv_len=L,
                                    linear_kv=True, interpret=True)
    for ref_kv, ref_ks in ((plain[3], plain[4]),
                           (torch.from_numpy(np.asarray(want[3])),
                            torch.from_numpy(np.asarray(want[4])))):
        torch.testing.assert_close(kv16, ref_kv, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ks16, ref_ks, rtol=1e-4, atol=1e-4)
    valid = (torch.arange(Lp) < L)[:, None]
    exact = torch.matmul(torch.where(valid, sf._softmax_d(kt.double()), 0.0)
                         .transpose(-1, -2), vi.double())
    kvb, _ = _kv_split_emulation(kt, vi, L, torch.bfloat16)
    assert (kvb - exact).abs().max() > 4 * (kv16 - exact).abs().max()


def test_k16_residual_step_gives_the_ieee_quotient():
    """K16's division-free rule (`quant8_wide`): t = fl(y / s) taken as
    fl(y inv) corrected by one FMA residual step, inv = 1/s rounded to
    nearest, equals the IEEE quotient for every bf16 amax in [1, 2) (other
    exponents scale exactly) and every bf16 y in [2^-11, amax] (smaller
    quotients round to 0): the FMAs emulated in float64 (r exact; the last
    sum checked off every fp32 midpoint)."""
    amax = (np.arange(0x3F80, 0x4000, dtype=np.uint32) << 16).view(np.float32)
    ys = (np.arange(0x3A00, 0x4000, dtype=np.uint32) << 16).view(np.float32)
    c = np.float32(1) / np.float32(127)
    for a in amax:
        s = np.float32(a * c)
        inv = np.float32(1) / s
        y = ys[ys <= a]
        t = (y * inv).astype(np.float32)
        r = (y.astype(np.float64) - t.astype(np.float64) * np.float64(s)).astype(np.float32)
        z = t.astype(np.float64) + r.astype(np.float64) * np.float64(inv)
        q = z.astype(np.float32)
        half_ulp = np.spacing(q).astype(np.float64) / 2
        assert (np.abs(np.abs(z - q) - half_ulp) > np.abs(z) * 2.0 ** -40).all()
        np.testing.assert_array_equal(q, (y / s).astype(np.float32))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _k7_inputs(L, bq, bk, ratio, seed, lin):
    """The operands of the fused path's K7 call, built with the port's
    plain versions from numpy-seeded planes (as numpy arrays)."""
    Lp = -(-L // 512) * 512
    q = np.zeros((1, H, Lp, DH), np.float32)
    q[:, :, :L] = _rand((1, H, L, DH), seed, 2.0)
    qi, qs = sf._quant_rows(torch.from_numpy(q))
    k, v = _k_and_v(L, Lp, seed + 1)
    kt = torch.from_numpy(k).bfloat16()
    mu = kt[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(torch.from_numpy(v).bfloat16(), L)
    kp, vtp, ks, *lin_sums = sf.subquant_pack_kvt(kt, mu, vi, bk, kv_len=L,
                                                  linear_kv=lin)
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = max(1, min(nK, int(ratio * nK)))
    r = np.random.RandomState(seed + 5)
    lut = np.stack([r.permutation(nK)[:sel] for _ in range(H * nQ)]
                   ).reshape(1, H, nQ, sel).astype(np.int32)
    args = [qi, qs, kp, vtp, ks, vcs]
    args = [a.numpy() for a in args] + [lut]
    kw = {}
    if lin:
        w = _rand((DH, DH), seed + 6, 0.3)
        b = _rand((DH,), seed + 7, 0.1)
        kv, ksum = lin_sums
        kvw = (kv * vcs).numpy() @ w                  # w in JAX's (in, out)
        ksb = np.concatenate([ksum.numpy(), np.broadcast_to(
            b, ksum.shape)], axis=2).astype(np.float32)
        kw = dict(lin_kvw=kvw.astype(np.float32), lin_ks_bias=ksb)
    return args, kw


@pytest.mark.parametrize("lin", [False, True])
@pytest.mark.parametrize("L,bq,bk,ratio", [(520, 128, 128, 0.5),
                                           (1024, 512, 256, 0.5),
                                           (1024, 128, 128, 0.3)])
def test_k7_plain_matches_jax(L, bq, bk, ratio, lin):
    args, kw = _k7_inputs(L, bq, bk, ratio, 10, lin)
    want = sparse_i8_vt_jax(*[jnp.asarray(a) for a in args], block_q=bq,
                            block_k=bk, kv_len=L, interpret=True,
                            **{n: jnp.asarray(a) for n, a in kw.items()})
    got = si8.sparse_attention_i8_vt(
        *[torch.from_numpy(a) for a in args], block_q=bq, block_k=bk,
        kv_len=L, **{n: torch.from_numpy(a) for n, a in kw.items()})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = _np(got)[:, :, :L], _np(want)[:, :, :L]
    assert np.abs(w).max() > 0.1
    np.testing.assert_allclose(g, w, atol=2e-2, rtol=0)


def test_sparse_vt_garbage_tail_cannot_collapse_rows():
    """The port of tests/test_attention.py::test_sparse_vt_garbage_tail_
    cannot_collapse_rows: tail rows of the last K block poisoned with +127
    (the largest int8 dot with an all-positive q) and +127 V change no live
    output row of K7's plain version (K6 packs the panels)."""
    B, bq, bk = 1, 128, 128
    kv_len, Lp = 1000, 1024
    nK = Lp // bk
    r = np.random.RandomState(3)
    q = np.abs(r.randn(B, 1, Lp, DH)).astype(np.float32) * 2.0
    k = r.randn(B, 1, Lp, DH).astype(np.float32)
    v = r.randn(B, 1, Lp, DH).astype(np.float32)
    k[:, :, kv_len:] = 0
    v[:, :, kv_len:] = 0
    qmax = np.abs(q).max(-1, keepdims=True)
    qi = torch.from_numpy(np.round(q / qmax * 127.0).astype(np.int8))
    qs = torch.from_numpy((qmax / 127.0).astype(np.float32)[..., 0])
    vi, vcs = si8.quantize_v_per_channel(torch.from_numpy(v).bfloat16(), kv_len)
    mu = torch.zeros(B, 1, 1, DH)
    kp, vtp, ksb = sf.subquant_pack_kvt(torch.from_numpy(k).bfloat16(), mu, vi,
                                        bk, kv_len=kv_len)
    lut = torch.arange(nK, dtype=torch.int32).expand(B, 1, Lp // bq, nK)

    def run(kp_, vtp_):
        o = si8.sparse_attention_i8_vt(qi, qs, kp_, vtp_, ksb, vcs, lut,
                                       block_q=bq, block_k=bk, kv_len=kv_len)
        return o[:, :, :kv_len].float().numpy()

    clean = run(kp, vtp)
    pk, pv = kp.clone(), vtp.clone()
    pk[:, :, kv_len:] = 127
    pv[:, :, -1, :, kv_len % bk:] = 127
    assert np.abs(clean).max() > 1e-3
    np.testing.assert_allclose(run(pk, pv), clean, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# sla_attention_fused and the DiT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_proj", [False, True])
@pytest.mark.parametrize("L,bq,bk,topk", [(520, 128, 128, 0.5),
                                          (1024, 512, 256, 0.5)])
def test_sla_attention_fused_matches_jax(L, bq, bk, topk, with_proj):
    xs = [_bf16(_rand((1, L, HD), s)) for s in (11, 12, 13)]
    wq = _bf16(1 + _rand((HD,), 14, 0.1))
    wk = _bf16(1 + _rand((HD,), 15, 0.1))
    (ct, st), _ = _tables(L)
    w = _rand((DH, DH), 16, 0.3) if with_proj else np.zeros((DH, DH), np.float32)
    b = _rand((DH,), 17, 0.1) if with_proj else np.zeros((DH,), np.float32)
    kw = dict(backend="sagesla", sla_topk=topk, block_q=bq, block_k=bk,
              linear_branch=with_proj, v_quant="channel")
    want = sla_attention_fused_jax(
        *[x[0] for x in xs], wq[0], wk[0],
        (jnp.asarray(ct.numpy()), jnp.asarray(st.numpy())),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, AttentionConfigJax(**kw),
        num_heads=H, eps=EPS, interpret=True)
    proj = torch.nn.Linear(DH, DH)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(w.T))
        proj.bias.copy_(torch.from_numpy(b))
        got = sla_attention_fused(*[x[1] for x in xs], wq[1], wk[1], (ct, st),
                                  proj, AttentionConfig(**kw), num_heads=H,
                                  eps=EPS)
    assert got.shape == want.shape == (1, H, -(-L // 512) * 512, DH)
    g, w_ = _np(got)[:, :, :L], _np(want)[:, :, :L]
    assert np.abs(w_).max() > 0.1
    np.testing.assert_allclose(g, w_, atol=2e-2, rtol=0)


@pytest.mark.parametrize("linear_branch", [False, True])
def test_wan_forward_fused_sagesla_matches_jax(monkeypatch, linear_branch):
    """The slice: WanModel.forward through the fused SageSLA branch (dim 256,
    2 heads x 128, 2 layers, blocks 128, L = 520 tokens, bf16) against JAX
    `wan_forward` made to take its fused branch (`_use_fused_sla` forced
    True, `sla_attention_fused` in interpret mode: test-only patches)."""
    import functools

    import turbodiffusion_tpu.models.wan as wan_jax
    import turbodiffusion_tpu.ops.attention as attention_jax
    from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
    from turbodiffusion_tpu.models.wan import init_wan_params as init_jax
    from turbodiffusion_tpu_torch.config import wan_test_config
    from turbodiffusion_tpu_torch.models.wan import WanModel
    from turbodiffusion_tpu_torch.ops import attention as attention_port
    from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

    monkeypatch.setattr(wan_jax, "_use_fused_sla", lambda p, cfg: True)
    monkeypatch.setattr(attention_jax, "sla_attention_fused", functools.partial(
        attention_jax.sla_attention_fused, interpret=True))
    attn = dict(backend="sagesla", sla_topk=0.5, block_q=128, block_k=128,
                linear_branch=linear_branch, v_quant="channel")
    size = dict(dim=256, ffn_dim=512, num_heads=2)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn),
                                dtype=jnp.bfloat16, **size)
    cfg_t = wan_test_config(attention=AttentionConfig(**attn),
                            dtype=torch.bfloat16, **size)
    params = jax.tree.map(np.array, jax.jit(init_jax, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))
    r = np.random.RandomState(1)
    head = params["head"]["head"]
    head["w"] = (0.05 * r.randn(*head["w"].shape)).astype(np.float32)
    if linear_branch:
        pl_ = params["blocks"]["self_attn"]["proj_l"]
        pl_["w"] = (0.2 * r.randn(*pl_["w"].shape)).astype(np.float32)
        pl_["b"] = (0.2 * r.randn(*pl_["b"].shape)).astype(np.float32)
    model = load_jax_params(WanModel(cfg_t), params)

    x = _rand((1, 16, 5, 16, 26), 2)              # 5 x 8 x 13 = 520 tokens
    t = np.full((1, 1), 537.0, np.float32)
    ctx = _rand((1, 16, 32), 3)
    want = np.asarray(wan_jax.wan_forward(
        jax.tree.map(jnp.asarray, params), cfg_j, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx)), np.float32)
    calls = []
    monkeypatch.setattr(attention_port, "sparse_attention_i8_vt",
                        _spy(calls, attention_port.sparse_attention_i8_vt))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).float().numpy()
    assert len(calls) == 2                      # one fused call per block
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def _spy(calls, fn):
    def wrapped(*a, **k):
        calls.append(k.get("lin_kvw") is not None)
        return fn(*a, **k)
    return wrapped
