"""The port's last four kernels, the fused SageSLA dispatch and the sagesla
gradients against the JAX package.

* K27 (`subquant_pack_kv` block-scale mode), K28 (block-scale
  `sparse_attention_i8_planes`), K29 (`subquant_planes`) and K30 (dense
  `flash_attention(..., int8_qk=True)`): their plain versions on CPU
  tensors against the JAX kernels in interpret mode, H = 2, Dh = 128.
* `sla_attention_fused` takes JAX's composition on both sides of its
  dispatch bound sel * block_k = 8,192 (attention.py:401-406): above it the
  block-scale pair (K27 + K28, and K21 over the planes with the linear
  branch on), below it K6 + K7; a record of the calls shows which ran.
* The gradients of `sla_attention_fused`, K20's sparse int8-QK form and
  K30's dense one against `jax.vjp` of JAX's (its straight-through custom
  VJPs, attention.py:293-333, flash_pallas.py:1982-2011).

Tolerances, with reasons:
  * int8 outputs at most 1 LSB, fp32 scales rtol 1e-6 (the same fp32 rule);
  * attention outputs in bf16 atol 2e-2 + rtol 2e-2 (bf16 output and P; the
    plain versions take one softmax pass where the TPU kernels stream
    groups of blocks, so P rounds to bf16 at another running max);
  * K20's and K30's gradients in fp32, atol 2e-3 + rtol 2e-3: the same
    fp32 math with sums over a few hundred keys in another order;
  * fused sagesla's gradients in bf16 (JAX's custom VJP takes no fp32
    planes: its backward hands the bf16 cotangent to an fp32 recompute),
    each within 2e-2 relative L2 of JAX's: bf16 rounding at other places
    in the sparse backward (P and dS rounded before their products here,
    XLA's autodiff of the jnp reference there) and the linear branch (fp32
    in K21, bf16 in JAX's CPU chain); 0.4-1.2% seen.
Inputs are numpy-seeded; q is sharpened (an RMSNorm weight of 2 or 4, or q
of std 3) so that each row's softmax leans on a few keys: flat attention
hides a wrong composition under the tolerance.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.ops import flash_pallas as fp_jax
from turbodiffusion_tpu.ops import sla_fused as sf_jax
from turbodiffusion_tpu.ops.attention import (
    sla_attention_fused as sla_attention_fused_jax)
from turbodiffusion_tpu_torch.config import AttentionConfig
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import attention as attention_port
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
from turbodiffusion_tpu_torch.ops.flash_attention import (
    flash_attention, sparse_flash_attention_i8qk)
from turbodiffusion_tpu_torch.ops.fused_norm import rope_cos_sin_full

H, DH = 2, 128
HD = H * DH
EPS = 1e-6
ATOL = RTOL = 2e-2
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
GRAD_REL = 2e-2


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


# ---------------------------------------------------------------------------
# K27, K28, K29
# ---------------------------------------------------------------------------

def _k_planes(Lp, kv_len, seed):
    """bf16 K planes (1, H, Lp, Dh) whose rows past kv_len hold 1e4 (which
    would win any statistic that took them) then NaN, a per-(b, h) mean,
    and int8 V planes."""
    k = _rand((1, H, Lp, DH), seed)
    k[:, :, kv_len:kv_len + 3] = 1e4
    k[:, :, kv_len + 3:] = np.nan
    mu = _rand((1, H, 1, DH), seed + 1, 0.1)
    v = np.random.RandomState(seed + 2).randint(-127, 128, (1, H, Lp, DH))
    return _bf16(k), mu, v.astype(np.int8)


def test_k27_block_scale_pack_matches_jax():
    Lp, kv_len, bk = 1024, 900, 256
    (kj, kt), mu, v = _k_planes(Lp, kv_len, 1)
    kvi_j, ks_j = sf_jax.subquant_pack_kv(kj, jnp.asarray(mu), jnp.asarray(v),
                                          bk, block_scales=True, kv_len=kv_len,
                                          interpret=True)
    kvi, ks = sf.subquant_pack_kv(kt, torch.from_numpy(mu), torch.from_numpy(v),
                                  block_k=bk, kv_len=kv_len)
    assert kvi.shape == (1, H, Lp, 2 * DH) and ks.shape == (1, H, Lp // bk)
    np.testing.assert_allclose(ks.numpy(), np.asarray(ks_j), rtol=1e-6)
    # no row past kv_len entered a block's statistic
    assert float(ks.max()) < 1.0
    kvi_j = np.asarray(kvi_j).reshape(1, H, Lp + bk, 2 * DH)
    _int8_close(kvi.numpy()[:, :, :kv_len], kvi_j[:, :, :kv_len])
    assert np.array_equal(kvi.numpy()[..., DH:], v)
    # the finite rows past kv_len are quantised with their block's scale
    assert np.abs(kvi.numpy()[:, :, kv_len:kv_len + 3, :DH]).max() == 127


def test_k29_subquant_planes_matches_jax():
    Lp = 1024
    (xj, xt), mu, _ = _k_planes(Lp, Lp, 4)
    i8_j, sc_j = sf_jax.subquant_planes(xj, jnp.asarray(mu), interpret=True)
    i8, sc = sf.subquant_planes(xt, torch.from_numpy(mu))
    assert i8.shape == (1, H, Lp, DH) and sc.shape == (1, H, Lp, 1)
    _int8_close(i8.numpy(), np.asarray(i8_j))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=1e-6)


def _k28_operands(L, Lp, bq, bk, topk, seed):
    """K28's operands as fused sagesla builds them, from q of std 3: int8 Q
    with row scales, K27's packed rows and block scales, V's channel
    scales, the top-k LUT; rows past L of K|V hold garbage (+127)."""
    r = np.random.RandomState(seed)
    q = r.randn(1, H, Lp, DH).astype(np.float32) * 3.0
    q[:, :, L:] = 0
    k, v = (torch.from_numpy(r.randn(1, H, Lp, DH).astype(np.float32)).bfloat16()
            for _ in range(2))
    qi, qs = sf._quant_rows(torch.from_numpy(q))
    vi, vcs = si8.quantize_v_per_channel(v, L)
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    kvi, ksb = sf.subquant_pack_kv(k, mu, vi, block_k=bk, kv_len=L)
    kvi[:, :, L:] = 127
    nK = Lp // bk
    sel = max(1, min(-(-L // bk), int(topk * -(-L // bk))))
    lut = np.stack([r.permutation(-(-L // bk))[:sel]
                    for _ in range(H * (Lp // bq))]).reshape(1, H, Lp // bq, sel)
    assert nK >= lut.max() + 1
    return qi, qs, kvi, ksb, vcs, torch.from_numpy(lut.astype(np.int32))


def test_k28_block_scale_attention_matches_jax():
    L, Lp, bq, bk = 900, 1024, 128, 256
    qi, qs, kvi, ksb, vcs, lut = _k28_operands(L, Lp, bq, bk, 0.5, 5)
    got = si8.sparse_attention_i8_planes(
        qi, qs, kvi, None, None, lut, block_q=bq, block_k=bk, kv_len=L,
        k_block_scale=ksb, v_channel_scale=vcs)
    kvi_j = np.pad(kvi.numpy().reshape(H, Lp, 2 * DH), ((0, 0), (0, bk), (0, 0)),
                   constant_values=127)
    zb = jnp.zeros((1, H, Lp, 1), jnp.float32)
    want = fp_jax.sparse_attention_i8_planes(
        jnp.asarray(qi.numpy()), jnp.asarray(qs.numpy()), None, zb, None, zb,
        jnp.asarray(lut.numpy()), block_q=bq, block_k=bk, kv_len=L,
        v_channel_scale=jnp.asarray(vcs.numpy()), kvi_packed=jnp.asarray(kvi_j),
        k_block_scale=jnp.asarray(ksb.numpy()), interpret=True)
    g, w = _np(got)[:, :, :L], _np(want)[:, :, :L]
    assert np.abs(w).max() > 0.5
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    # the garbage tail is masked: rows past L of K|V change no live row
    kvi2 = kvi.clone()
    kvi2[:, :, L:] = -127
    again = si8.sparse_attention_i8_planes(
        qi, qs, kvi2, None, None, lut, block_q=bq, block_k=bk, kv_len=L,
        k_block_scale=ksb, v_channel_scale=vcs)
    assert torch.equal(again[:, :, :L], got[:, :, :L])


# ---------------------------------------------------------------------------
# K30 and the int8-QK gradients
# ---------------------------------------------------------------------------

def _qkv(L, seed):
    q = _rand((1, L, H, DH), seed, 3.0)
    k, v = _rand((1, L, H, DH), seed + 1), _rand((1, L, H, DH), seed + 2)
    return q, k, v


@pytest.mark.parametrize("L", [256, 200])
def test_k30_dense_int8_flash_attention_matches_jax(L):
    qkv = _qkv(L, 10)
    bf = [_bf16(a) for a in qkv]
    want = fp_jax.flash_attention(*(a[0] for a in bf), int8_qk=True,
                                  interpret=True)
    got = flash_attention(*(a[1] for a in bf), int8_qk=True)
    assert got.shape == (1, L, H, DH) and got.dtype == torch.bfloat16
    assert np.abs(_np(want)).max() > 0.5
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)


def _vjp_check(port_fn, jax_fn, ins, cot):
    """port_fn's gradients (autograd) against jax.vjp of jax_fn, fp32."""
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = port_fn(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in ins))
    want = vjp(jnp.asarray(cot))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-3, i
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=str(i))


def test_k30_gradients_are_jax_straight_through():
    L = 200
    ins = list(_qkv(L, 20))
    _vjp_check(lambda q, k, v: flash_attention(q, k, v, int8_qk=True),
               lambda q, k, v: fp_jax.flash_attention(q, k, v, int8_qk=True,
                                                      interpret=True),
               ins, _rand((1, L, H, DH), 23))


def test_k20_gradients_are_jax_straight_through():
    L, blk = 200, 64
    ins = list(_qkv(L, 30))
    nQ = -(-L // blk)
    lut = np.stack([np.random.RandomState(31 + i).permutation(nQ)[:2]
                    for i in range(H * nQ)]).reshape(1, H, nQ, 2).astype(np.int32)
    _vjp_check(lambda q, k, v: sparse_flash_attention_i8qk(
                   q, k, v, torch.from_numpy(lut), blk, blk),
               lambda q, k, v: fp_jax.flash_attention(
                   q, k, v, lut=jnp.asarray(lut), block_q=blk, block_k=blk,
                   int8_qk=True, interpret=True),
               ins, _rand((1, L, H, DH), 33))


# ---------------------------------------------------------------------------
# sla_attention_fused: dispatch and gradients
# ---------------------------------------------------------------------------

def _tables(L):
    """rotate-half tables of a (T, 8, 26) grid cut to L rows."""
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(-(-L // 208), 8, 26, DH))
    return cosF[:L].contiguous(), sinF[:L].contiguous()


def _fused_inputs(L, seed):
    """Raw projections (1, L, H*Dh), norm weights of ~3 (sharp q and k),
    proj_l's weight (out, in) and bias, as fp32 numpy."""
    xs = [_rand((1, L, HD), seed + i) for i in range(3)]
    # powers of two: the weight product is exact in bf16, so JAX's CPU
    # kernel, which skips its rounding (XLA's excess precision), and the
    # port agree on q and k, and a sharp q does not amplify that step
    wq, wk = (np.random.RandomState(seed + i).choice(c, HD).astype(np.float32)
              for i, c in ((3, (2.0, 4.0)), (4, (0.5, 1.0))))
    w, b = _rand((DH, DH), seed + 5, 0.3), _rand((DH,), seed + 6, 0.1)
    return xs, wq, wk, w, b


def _spy(monkeypatch, calls):
    """Record the fused path's kernel calls by name."""
    for name in ("subquant_pack_kvt", "sparse_attention_i8_vt",
                 "subquant_pack_kv", "sparse_attention_i8_planes",
                 "linear_projected_planes"):
        fn = getattr(attention_port, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            if _name == "sparse_attention_i8_planes" and \
                    k.get("k_block_scale") is not None:
                _name += " block-scale"
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(attention_port, name, wrapped)


@pytest.mark.parametrize("with_proj", [False, True])
@pytest.mark.parametrize("L,topk,pair", [
    (8600, 1.0, ["subquant_pack_kv", "sparse_attention_i8_planes block-scale"]),
    (1024, 0.5, ["subquant_pack_kvt", "sparse_attention_i8_vt"])])
def test_sla_attention_fused_dispatch_matches_jax(monkeypatch, L, topk, pair,
                                                  with_proj):
    """At blocks 512/256: L 8,600, topk 1.0 gives sel 34 of 34 K blocks,
    34 x 256 = 8,704 > 8,192 (JAX's block-scale branch); L 1,024, topk 0.5
    gives 2 x 256 (the VT kernel)."""
    xs, wq, wk, w, b = _fused_inputs(L, 40)
    bfx = [_bf16(x) for x in xs]
    bq, bk = _bf16(wq), _bf16(wk)
    ct, st = _tables(L)
    Lp = -(-L // 512) * 512
    pad = ((0, Lp - L), (0, 0))
    kw = dict(backend="sagesla", sla_topk=topk, block_q=512, block_k=256,
              linear_branch=with_proj, v_quant="channel")
    want = sla_attention_fused_jax(
        *[x[0] for x in bfx], bq[0], bk[0],
        (jnp.asarray(np.pad(ct.numpy(), pad)), jnp.asarray(np.pad(st.numpy(), pad))),
        {"w": jnp.asarray(w.T), "b": jnp.asarray(b)}, AttentionConfigJax(**kw),
        num_heads=H, eps=EPS, interpret=True)
    proj = torch.nn.Linear(DH, DH)
    calls = []
    _spy(monkeypatch, calls)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(w))
        proj.bias.copy_(torch.from_numpy(b))
        got = attention_port.sla_attention_fused(
            *[x[1] for x in bfx], bq[1], bk[1], (ct, st), proj,
            AttentionConfig(**kw), num_heads=H, eps=EPS)
    assert calls == pair + (["linear_projected_planes"]
                            if with_proj and L > 1024 else [])
    assert got.shape == want.shape == (1, H, Lp, DH)
    g, w_ = _np(got)[:, :, :L], _np(want)[:, :, :L]
    assert np.abs(w_).max() > 0.5
    np.testing.assert_allclose(g, w_, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("v_quant,with_proj", [("channel", True),
                                               ("row", True),
                                               ("channel", False)])
def test_sla_attention_fused_gradients_match_jax(monkeypatch, v_quant,
                                                 with_proj):
    """jax.vjp of JAX's fused sagesla (its backward: the composable path,
    on the CPU the jnp sparse reference and linear chain) against the
    port's autograd (K2's, K20's straight-through K23 + K24 and K21's
    backward, plain on the CPU) at L 520 (Lp 1,024), blocks 128, topk 0.5:
    the gradients of the three projections, both norm weights and, with the
    branch on, proj_l's weight and bias. bf16 projections and norm weights,
    fp32 proj_l, as in the model (JAX's custom VJP takes no fp32 planes).
    Each gradient within GRAD_REL relative L2 of JAX's. The port's
    recompute carries only the VJP: it never runs K20's forward (here its
    plain version, made to raise)."""
    from turbodiffusion_tpu_torch.ops import flash_attention as fa

    def refuse(*a, **k):
        raise AssertionError("the backward ran the sparse int8-QK forward")

    monkeypatch.setattr(fa, "sparse_flash_attention_i8qk_plain", refuse)
    L, Lp = 520, 1024
    xs, wq, wk, w, b = _fused_inputs(L, 50)
    ct, st = _tables(L)
    kw = dict(backend="sagesla", sla_topk=0.5, block_q=128, block_k=128,
              linear_branch=with_proj, v_quant=v_quant)
    rope_j = (jnp.asarray(ct.numpy()), jnp.asarray(st.numpy()))
    cot = _rand((1, H, Lp, DH), 57)
    cot[:, :, L:] = 0            # the O projection reads rows < L
    n = 7 if with_proj else 5
    bf = [_bf16(a) for a in (*xs, wq, wk)]
    ts = [t.requires_grad_() for _, t in bf] + [
        torch.from_numpy(a).requires_grad_() for a in (w, b)]
    out = attention_port.sla_attention_fused(
        *ts[:5], (ct, st), SimpleNamespace(weight=ts[5], bias=ts[6]),
        AttentionConfig(**kw), num_heads=H, eps=EPS)
    cot_t = torch.from_numpy(cot).bfloat16()
    got = torch.autograd.grad(out, ts[:n], cot_t)

    def jax_fn(qp, kp, vp, nq, nk, pw, pb):
        return sla_attention_fused_jax(
            qp, kp, vp, nq, nk, rope_j, {"w": pw.T, "b": pb},
            AttentionConfigJax(**kw), num_heads=H, eps=EPS, interpret=True)

    _, vjp = jax.vjp(jax_fn, *(j for j, _ in bf), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(cot_t.float().numpy(), jnp.bfloat16))
    for i, (g, w_) in enumerate(zip(got, want[:n])):
        g, w_ = _np(g), _np(w_)
        rel = np.linalg.norm(g - w_) / np.linalg.norm(w_)
        assert np.abs(w_).max() > 1e-3 and rel < GRAD_REL, (i, rel)

