"""K21's arithmetic on the tensor cores, emulated in plain torch on the CPU,
against JAX's TPU kernel in interpret mode and against float64 sums; and
the cause of K6's kv error at 40 heads (ROADMAP Queue C 5).

The kv pass (csrc/linear_attention.cu `k21::kv_kernel`) splits fp32 phi =
softmax_D(k) by truncation into three bf16 parts, h1 + h2 + h3 = phi
exactly, and takes bf16 V as it lies, so each 16-row k step's products
are exact; the tensor core adds them to the fragment, which holds minus the
Kahan compensation of the fp32 sum, and rounds that once to fp32 (the
emulation sums a step in float64 and rounds to nearest). The steps go into
the fp32 sum under that compensation, in runs of the flat (b, h, 64-row
chunk) order as `la.kv_grid` splits it, and a head's run partials are
added in run order.
The apply pass (`k21::apply_kernel`) takes phi(q) and kvw each as a bf16
hi + lo pair (round to nearest) and sums hi hi + hi lo + lo hi in fp32.

Tolerances: kv and ksum rtol / atol 1e-4 of the float64 sums (the card
tests' `_assert_kv_sums`); the output at the K21 CPU tests' bf16 tolerance
against JAX, and its mean distance from the float64 output at most 1.1x the
fp32 plain version's (what the fp32 kernel before the tensor cores gave).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.ops import linear_attention_pallas as la_jax
from turbodiffusion_tpu_torch.ops import linear_attention as la
from turbodiffusion_tpu_torch.ops import sla_fused as sf

H, DH, ROWS, STEP = 2, 128, 64, 16


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """(jax bf16, torch bf16) of the same values."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _split3(x):
    """The kv pass's split of fp32 x: h1, h2 the high halves (bf16) of x and
    of x - h1, h3 = x - h1 - h2."""
    h1 = (x.view(torch.int32) & -65536).view(torch.float32)
    r1 = x - h1
    h2 = (r1.view(torch.int32) & -65536).view(torch.float32)
    return [h1, h2, r1 - h2]


def _split_bf16_rn(x):
    """The rejected split: bf16 hi + lo, each rounded to nearest."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def _kv_emulation(k, v, kv_len, resident, split):
    """K21's kv / ksum over (B, H, L, D) bf16 k and v: phi as `split` parts,
    each 16-row k step's products summed exactly less the compensation and
    rounded to fp32, the steps of a run and head Kahan-summed in fp32, the
    run partials of a head added in run order in fp32."""
    B, Hh, L, D = k.shape
    nC = -(-kv_len // ROWS)
    pad = nC * ROWS - L
    valid = (torch.arange(L) < kv_len)[:, None]
    phi = torch.where(valid, la._softmax_d(k.float()), 0.0)
    vz = torch.where(valid, v.double(), 0.0)
    phi = torch.nn.functional.pad(phi, (0, 0, 0, max(pad, 0)))[:, :, :nC * ROWS]
    vz = torch.nn.functional.pad(vz, (0, 0, 0, max(pad, 0)))[:, :, :nC * ROWS]
    ns = ROWS // STEP
    parts = [p.double().reshape(B * Hh, nC * ns, STEP, D) for p in split(phi)]
    vc = vz.reshape(B * Hh, nC * ns, STEP, D)
    prod = sum(torch.einsum("ncrx,ncry->ncxy", p, vc) for p in parts)
    rows = phi.double().reshape(B * Hh, nC, ROWS, D).sum(2)
    total = B * Hh * nC
    grid = la.kv_grid(B, Hh, kv_len, resident)
    kv = torch.zeros(B * Hh, D, D)
    ksum = torch.zeros(B * Hh, D)
    for i in range(grid):
        a, e = i * total // grid, (i + 1) * total // grid
        for bh in range(a // nC, (e - 1) // nC + 1):
            c0, c1 = max(a, bh * nC) - bh * nC, min(e, (bh + 1) * nC) - bh * nC
            acc, comp = torch.zeros(D, D), torch.zeros(D, D)
            for st in range(c0 * ns, c1 * ns):
                y = (prod[bh, st] - comp.double()).float()
                t = acc + y
                comp = (t - acc) - y
                acc = t
            kv[bh] = kv[bh] + (acc - comp)
            ksum[bh] = ksum[bh] + rows[bh, c0:c1].sum(0).float()
    return kv.reshape(B, Hh, D, D), ksum.reshape(B, Hh, 1, D)


def _kv_exact(k, v, kv_len):
    valid = (torch.arange(k.shape[2]) < kv_len)[:, None]
    phi = torch.where(valid, torch.softmax(k.double(), -1), 0.0)
    return (torch.matmul(phi.transpose(-1, -2), torch.where(valid, v.double(), 0.0)),
            phi.sum(2, keepdim=True))


def _apply_emulation(q, kvw, ksum, bias):
    """K21's apply pass: num = phi_hi kvw_hi + phi_hi kvw_lo + phi_lo kvw_hi
    (products exact, fp32 out), den = 1e-5 + phi . ksum in fp32, o = num
    (1 / den) + bias, bf16."""
    phi = la._softmax_d(q.float())
    a, b = _split_bf16_rn(phi), _split_bf16_rn(kvw)
    num = sum(torch.matmul(a[i].double(), b[j].double())
              for i, j in ((0, 0), (0, 1), (1, 0))).float()
    den = 1e-5 + (phi * ksum).sum(-1, keepdim=True)
    return (num * (1.0 / den) + bias).bfloat16()


def _v_beyond_fp16(shape, seed):
    """bf16 V of N(0, 1) with one row in 16 at 2^17 (1 + |N(0, 1)|), past
    fp16's 65,504, and one in 16 scaled by 2^-20, below fp16's normal 2^-14.
    The large rows share a sign: +-2^17 terms that cancel to ~0.1 in a kv
    element are beyond any fp32 sum (the fp32 plain version lies ~90x
    rtol / atol 1e-4 from float64 on such V)."""
    v = _rand(shape, seed)
    v[..., 3::16, :] = 2.0 ** 17 * (1 + np.abs(v[..., 3::16, :]))
    v[..., 7::16, :] *= 2.0 ** -20
    return v


def test_three_part_split_is_exact():
    """h1 + h2 + h3 = x for fp32 x over 2^-100 .. 2^1, each part a bf16 (an
    fp32 whose low 16 bits are zero): the kv pass's products are exact."""
    x = torch.from_numpy(np.exp2(np.random.RandomState(0).uniform(-100, 1, 200000))
                         .astype(np.float32))
    parts = _split3(x)
    for p in parts:
        assert bool(((p.view(torch.int32) & 0xFFFF) == 0).all())
    assert torch.equal(sum(p.double() for p in parts), x.double())


def test_split_rule_matches_the_kernel_source():
    """The chunk and step rows, the split, the sums and the products the
    emulations assume are the CUDA source's (`k21::`)."""
    import re
    from pathlib import Path
    src = (Path(la.__file__).resolve().parent.parent / "csrc" / "linear_attention.cu").read_text()
    assert int(re.search(r"constexpr int kRows = (\d+);", src).group(1)) == ROWS == la._KV_ROWS
    # part k: the high half of what parts 0 .. k - 1 leave, the last part all of it
    assert ("h[e] = __float_as_uint(x[j][e]) & (k + 1 < kParts ? 0xffff0000u : 0xffffffffu);"
            in src)
    assert "x[j][e] = __fsub_rn(x[j][e], __uint_as_float(h[e]));" in src
    assert "constexpr int kParts = 3;" in src
    # a fragment a 16-row k step, Kahan's compensation kept in it
    assert "for (int ks = 0; ks < kRows / 16; ++ks) {" in src
    assert "frag[e] = __fsub_rn(frag[e], __fsub_rn(t, acc[e]));" in src
    for line in ("wgmma_bf16_rs<1>(acc, ah + 4 * ks, dh);",
                 "wgmma_bf16_rs<1>(acc, ah + 4 * ks, dl);",
                 "wgmma_bf16_rs<1>(acc, al + 4 * ks, dh);"):
        assert line in src


@pytest.mark.parametrize("vkind", ["beyond fp16", "int8-valued"])
def test_kv_emulation_within_1e4_of_float64(vkind):
    """The kv pass's arithmetic on bf16 V beyond fp16's range (which fp16
    cannot hold: inf and lost bits) and on int8-valued V (|kv| ~ 100, where
    plain fp32 sums of the steps drift): kv and ksum within rtol / atol
    1e-4 of float64, across runs that split heads (12 blocks); the rejected
    split, bf16 hi + lo of phi rounded to nearest, lies farther."""
    L, Lp = 3000, 3072
    k = torch.from_numpy(_rand((1, H, Lp, DH), 20)).bfloat16()
    if vkind == "beyond fp16":
        v = torch.from_numpy(_v_beyond_fp16((1, H, Lp, DH), 21)).bfloat16()
        assert not bool(torch.isfinite(v.half()).all())
        assert not torch.equal(v[..., 7::16, :].half().float(), v[..., 7::16, :].float())
    else:
        v = torch.from_numpy(np.random.RandomState(21).randint(
            -127, 128, (1, H, Lp, DH)).astype(np.float32)).bfloat16()
    k[:, :, L:] = float("nan")
    v[:, :, L:] = float("nan")
    kv, ksum = _kv_emulation(k, v, L, 12, _split3)
    ex_kv, ex_ks = _kv_exact(k, v, L)
    torch.testing.assert_close(kv.double(), ex_kv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ksum.double(), ex_ks, rtol=1e-4, atol=1e-4)
    kv2, _ = _kv_emulation(k, v, L, 12, _split_bf16_rn)
    err3 = ((kv.double() - ex_kv).abs() / (1e-4 + 1e-4 * ex_kv.abs())).max()
    err2 = ((kv2.double() - ex_kv).abs() / (1e-4 + 1e-4 * ex_kv.abs())).max()
    assert err2 > 4 * err3


def test_apply_emulation_matches_jax_and_float64():
    """The whole branch over (B, H, Lp, D) planes (the fused path's form):
    the emulated kv pass, kvw = kv @ W^T in fp32, the emulated apply pass,
    against JAX's `linear_projected_planes` in interpret mode at the K21
    tests' bf16 tolerance; against the float64 branch, its mean error at
    most 1.1x the fp32 plain version's, which phi(q) from its bf16 hi
    alone (one product a k step) exceeds."""
    L, Lp = 1000, 1024
    (qj, qt), (kj, kt) = (_bf16(_rand((1, H, Lp, DH), s, 2.0)) for s in (30, 31))
    vj, vt = _bf16(_rand((1, H, Lp, DH), 32))
    w = _rand((DH, DH), 33, 0.1)                   # JAX's (in, out)
    b = _rand((DH,), 34, 0.1)
    W, bt = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    kv, ksum = _kv_emulation(kt, vt, L, 8, _split3)
    kvw = torch.matmul(kv, W.t())
    got = _apply_emulation(qt, kvw, ksum, bt)
    want = torch.from_numpy(np.asarray(la_jax.linear_projected_planes(
        qj, kj, vj, jnp.asarray(w), b=jnp.asarray(b), true_len=L, block=512,
        interpret=True), np.float32))
    g, wt = got[:, :, :L].float(), want[:, :, :L]
    assert bool((((g - wt).abs()) <= 2e-2 + 2.0 ** -8 * wt.abs()).all())
    ex_kv, ex_ks = _kv_exact(kt, vt, L)
    pq = torch.softmax(qt.double(), -1)
    o64 = (torch.matmul(pq, torch.matmul(ex_kv, W.double().t()))
           / (1e-5 + (pq * ex_ks).sum(-1, keepdim=True)) + bt.double())[:, :, :L]
    plain = la.linear_projected_planes_plain(qt, kt, vt, W, bt, L)[:, :, :L]
    e_got = (g.double() - o64).abs().mean()
    e_plain = (plain.double() - o64).abs().mean()
    assert e_got <= 1.1 * e_plain
    phi = la._softmax_d(qt.float())
    one = (torch.matmul(phi.bfloat16().float().double(), kvw.double()).float()
           / (1e-5 + (phi * ksum).sum(-1, keepdim=True)) + bt).bfloat16()[:, :, :L]
    assert (one.double() - o64).abs().mean() > 1.1 * e_plain


def test_k6_kv_error_is_its_fp32_step_sums():
    """ROADMAP Queue C 5: K6's kv at 40 heads on uniform int8 V (its
    1.25x rtol / atol 1e-4 of float64, PERF.md). K6's arithmetic emulated on
    two heads at 32,760 rows, with K6's runs at 40 heads
    (`sf.kvt_grid`, 132 blocks): exact products of fp16 hi / lo of 2^8 phi
    each 32-row step, rounded once to fp32, then summed in fp32 over the
    run as K6 sums them. The same step values under a Kahan compensation
    lie at under half the plain sums' mean error: the error is the fp32
    running sum of the steps, not the products."""
    L, Lp, bk, heads = 32760, 32768, 256, 40
    nK = Lp // bk
    grid = sf.kvt_grid(1, heads, Lp, bk, 132, True)
    runs = sf.kvt_runs(heads * nK, grid)
    errs = {"plain": [], "kahan": []}
    for h in range(2):
        k = torch.from_numpy(_rand((Lp, DH), 40 + h)).bfloat16()
        v = torch.from_numpy(np.random.RandomState(50 + h).randint(
            -127, 128, (Lp, DH)).astype(np.float32))
        k[L:], v[L:] = 0, 0
        valid = (torch.arange(Lp) < L)[:, None]
        s = torch.where(valid, sf._softmax_d(k.float()), 0.0) * 256
        hi = s.half().float()
        lo = (s - hi).half().float()
        vd = v.double().reshape(-1, 32, DH)
        steps = (torch.einsum("srx,sry->sxy", hi.double().reshape(-1, 32, DH), vd)
                 + torch.einsum("srx,sry->sxy", lo.double().reshape(-1, 32, DH), vd)).float()
        exact = torch.where(valid, torch.softmax(k.double(), -1), 0.0).t() @ v.double()
        for mode in errs:
            tot = torch.zeros(DH, DH)
            for a, e in runs:
                b0, b1 = max(a, h * nK), min(e, (h + 1) * nK)
                if b0 >= b1:
                    continue
                acc, comp = torch.zeros(DH, DH), torch.zeros(DH, DH)
                for st in range((b0 - h * nK) * bk // 32, (b1 - h * nK) * bk // 32):
                    y = steps[st] - comp if mode == "kahan" else steps[st]
                    t = acc + y
                    if mode == "kahan":
                        comp = (t - acc) - y
                    acc = t
                tot = tot + (acc - comp) / 256
            errs[mode].append(float((tot.double() - exact).abs().mean()))
    assert sum(errs["kahan"]) < 0.5 * sum(errs["plain"])


@pytest.mark.parametrize("B,Hh,Lq,kv_len,ok", [
    (1, 12, 32768, 32760, True), (2, 40, 32760, 32760, True), (1, 12, 40, 40, True),
    (1, 1, 1, 1, True), (1, 12, 0, 32760, False), (1, 12, 32760, 0, False)])
def test_linear_form_and_grid(B, Hh, Lq, kv_len, ok):
    """`la.linear_form` names the one form K21 takes ("wgmma") and refuses
    empty shapes, views off 16 bytes and strides off 8 elements, as the C
    query does (the card test compares them); `la.kv_grid` gives one block
    a resident slot, at least one a (b, h), at most one a 64-row chunk, as
    `k21::kv_grid`."""
    st = [Lq * Hh * DH, DH, Hh * DH] * 4
    ptrs = [1 << 20, (1 << 20) + 4096, (1 << 20) + 8192, (1 << 20) + 12288]
    if not ok:
        with pytest.raises(ValueError):
            la.linear_form(B, Hh, Lq, kv_len, ptrs, st)
        return
    assert la.linear_form(B, Hh, Lq, kv_len, ptrs, st) == "wgmma"
    for bad_ptrs, bad_st in ((ptrs[:3] + [ptrs[3] + 2], st), (ptrs, st[:11] + [Hh * DH + 4]),
                             (ptrs, [0] + st[1:])):
        with pytest.raises(ValueError):
            la.linear_form(B, Hh, Lq, kv_len, bad_ptrs, bad_st)
    chunks = B * Hh * -(-kv_len // ROWS)
    for resident in (1, 132, 264):
        grid = la.kv_grid(B, Hh, kv_len, resident)
        assert min(chunks, B * Hh) <= grid <= chunks
        assert grid == min(chunks, max(resident, B * Hh))
