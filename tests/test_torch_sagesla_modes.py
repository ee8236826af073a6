"""The other SageSLA configurations of the PyTorch port against the JAX
package: `v_quant="row"` (K18 subquant_pack_kv, K19 per-row
sparse_attention_i8_planes), `--sla_block 64` (K20, the int8-QK gather for
blocks < 128) and the SLA linear branch (K21, linear_projected_planes and
linear_attention_projected), plus the batch-2 W8A8 forward.

The port takes each kernel's plain version on CPU tensors; the JAX kernels
run in interpret mode. Inputs are numpy-seeded, H = 2, Dh = 128, L <= 520
(a ragged tail). Tolerances, with reasons:
  * K18: int8 K at most 1 LSB (fp32 arithmetic in another order can cross
    a rounding boundary), V equal, fp32 scales rtol 1e-5;
  * K19, K20: atol 2e-2 on outputs ~1 (bf16 outputs and the bf16 rounding
    of p; the plain versions keep the one-pass softmax, the TPU kernels
    stream groups of blocks);
  * K21: bf16 planes and (B, L, H, D) outputs atol 2e-2 + one bf16 step of
    the largest value (fp32 sums in another order, then one bf16 rounding);
    `sla` at bf16 against JAX's jnp chain (phi, o_l and proj_l in bf16):
    atol 2e-2 + two bf16 steps, and the port no further than JAX from the
    fp32 forward;
  * the 2-layer W8A8 forwards (bf16): as tests/test_torch_quant.py, both
    packages against the unquantised forward (the port's mean error at most
    1.2x JAX's plus 1e-4) and against each other within 2% of the largest
    velocity (int8 noise through two blocks: JAX quantises linear inputs in
    bf16 off the TPU, the port with K8's fp32 rule).
LUT rows come from the port's block map and go to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
from turbodiffusion_tpu.ops import flash_pallas as fp_jax
from turbodiffusion_tpu.ops import linear_attention_pallas as la_jax
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu.ops import sla_fused as sf_jax
from turbodiffusion_tpu_torch.config import AttentionConfig, wan_test_config
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import attention as attention_port
from turbodiffusion_tpu_torch.ops import linear_attention as la
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
from turbodiffusion_tpu_torch.ops.attention import get_block_map
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

H, DH = 2, 128
ATOL = 2e-2
BF16_STEP = 2.0 ** -8


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


def _close_bf16(got, want):
    g, w = _np(got), _np(want)
    assert np.isfinite(g).all() and np.abs(w).max() > 0.1
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=ATOL + BF16_STEP * np.abs(w).max())


# ---------------------------------------------------------------------------
# K18 and K19: the v_quant="row" pair
# ---------------------------------------------------------------------------

def _row_operands(L, seed):
    """K planes with a non-zero mean and per-row int8 V (K5's outputs), zero
    past L, padded to Lp = L rounded up to 512."""
    Lp = -(-L // 512) * 512
    k = np.zeros((1, H, Lp, DH), np.float32)
    k[:, :, :L] = _rand((1, H, L, DH), seed) + _rand((1, H, 1, DH), seed + 1)
    v = np.zeros((1, H, Lp, DH), np.float32)
    v[:, :, :L] = _rand((1, H, L, DH), seed + 2)
    vi, vs = sf._quant_rows(torch.from_numpy(v))
    kt = torch.from_numpy(k).bfloat16()
    mu = kt[:, :, :L].float().mean(2, keepdim=True)
    return kt, mu, vi, vs


def test_k18_plain_matches_jax():
    L = 520
    kt, mu, vi, _ = _row_operands(L, 1)
    kvi_j, ks_j = sf_jax.subquant_pack_kv(
        jnp.asarray(kt.float().numpy(), jnp.bfloat16), jnp.asarray(mu.numpy()),
        jnp.asarray(vi.numpy()), 256, interpret=True)
    kvi, ks = sf.subquant_pack_kv(kt, mu, vi)
    Lp = kt.shape[2]
    assert kvi.shape == (1, H, Lp, 2 * DH) and ks.shape == (1, H, Lp)
    kvi_j = np.asarray(kvi_j).reshape(1, H, -1, 2 * DH)[:, :, :L]
    _int8_close(kvi[:, :, :L, :DH].numpy(), kvi_j[..., :DH])
    np.testing.assert_array_equal(kvi[:, :, :L, DH:].numpy(), kvi_j[..., DH:])
    np.testing.assert_allclose(ks[:, :, :L].numpy(),
                               np.asarray(ks_j)[:, :, :L, 0], rtol=1e-5)


@pytest.mark.parametrize("L,bq,bk,ratio", [(520, 128, 128, 0.5),
                                           (1000, 512, 256, 0.5)])
def test_k19_plain_matches_jax_with_a_garbage_tail(L, bq, bk, ratio):
    """Rows at or past kv_len hold garbage in both packages: K|V rows of
    +127 and NaN K / V scales, which must reach no live output row."""
    kt, mu, vi, vs = _row_operands(L, 2)
    Lp = kt.shape[2]
    q = np.zeros((1, H, Lp, DH), np.float32)
    q[:, :, :L] = _rand((1, H, L, DH), 5, 2.0)
    qi, qs = sf._quant_rows(torch.from_numpy(q))
    kvi, ks = sf.subquant_pack_kv(kt, mu, vi)
    kvi[:, :, L:] = 127
    ks[:, :, L:] = float("nan")
    vs = vs.clone()
    vs[:, :, L:] = float("nan")
    nQ, nK = Lp // bq, -(-L // bk)
    sel = max(1, min(nK, int(ratio * nK)))
    r = np.random.RandomState(6)
    lut = np.stack([r.permutation(nK)[:sel] for _ in range(H * nQ)]
                   ).reshape(1, H, nQ, sel).astype(np.int32)
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    # the TPU layout: (B*H, Lp + block_k, 2D) with the poison block appended
    kvi_j = np.pad(kvi.numpy().reshape(H, Lp, 2 * DH), ((0, 0), (0, bk), (0, 0)))
    want = fp_jax.sparse_attention_i8_planes(
        jnp.asarray(qi.numpy()), jnp.asarray(qs.numpy()[..., None]), None,
        jnp.asarray(ks.numpy()[..., None]), None,
        jnp.asarray(vs.numpy()[..., None]), jnp.asarray(lut),
        kvi_packed=jnp.asarray(kvi_j), interpret=True, **kw)
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, ks, vs,
                                         torch.from_numpy(lut), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (1, H, Lp, DH)
    _close_bf16(got[:, :, :L], np.asarray(want)[:, :, :L])


# ---------------------------------------------------------------------------
# K20: sagesla at --sla_block 64
# ---------------------------------------------------------------------------

def test_k20_plain_through_attention_matches_jax():
    """The port's attention() at sagesla 64/64 (smooth-k, then K20's plain
    version) against JAX flash_attention(..., int8_qk=True), whose
    sub-128-block branch runs the int8-QK gather kernel."""
    L = 520
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(_rand((1, L, H, DH), s))
                                    for s in (7, 8, 9))
    cfg = AttentionConfig(backend="sagesla", sla_topk=0.5, block_q=64,
                          block_k=64, linear_branch=False)
    _, lut, sel = get_block_map(qt, kt, cfg.sla_topk, 64, 64)
    assert sel == 4 and lut.shape == (1, H, 9, 4)
    want = fp_jax.flash_attention(qj, kj, vj, jnp.asarray(lut.numpy()),
                                  block_q=64, block_k=64, int8_qk=True,
                                  interpret=True)
    got = attention_port.attention(qt, kt, vt, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (1, L, H, DH)
    _close_bf16(got, want)


# ---------------------------------------------------------------------------
# K21: the linear branch
# ---------------------------------------------------------------------------

def _proj(seed):
    """proj_l as JAX stores it, w (in, out), and its bias."""
    return _rand((DH, DH), seed, 0.3), _rand((DH,), seed + 1, 0.1)


def test_k21_planes_plain_matches_jax_with_nan_rows():
    """linear_projected_planes over (B, H, Lp, D) planes whose rows past
    true_len are NaN: they stay out of kv / ksum (the TPU kernel's where()
    on k and v), and garbage rows out are not compared."""
    L, Lp = 500, 512
    planes = []
    for s in (10, 11, 12):
        a = np.full((1, H, Lp, DH), np.nan, np.float32)
        a[:, :, :L] = _rand((1, H, L, DH), s, 2.0)
        planes.append(_bf16(a))
    w, b = _proj(13)
    want = la_jax.linear_projected_planes(
        *[p[0] for p in planes], jnp.asarray(w), jnp.asarray(b), true_len=L,
        block=128, interpret=True)
    got = la.linear_projected_planes(
        *[p[1] for p in planes], torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), L)
    assert got.dtype == torch.bfloat16 and got.shape == (1, H, Lp, DH)
    _close_bf16(got[:, :, :L], np.asarray(want)[:, :, :L])


def test_k21_strided_plain_matches_jax():
    """linear_attention_projected over (B, L, H, D) bf16 (the sla path's
    form), output in q's dtype."""
    L = 300
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(_rand((1, L, H, DH), s, 2.0))
                                    for s in (14, 15, 16))
    w, b = _proj(17)
    want = la_jax.linear_attention_projected(qj, kj, vj, jnp.asarray(w),
                                             jnp.asarray(b), block=128,
                                             interpret=True)
    got = la.linear_attention_projected(qt, kt, vt,
                                        torch.from_numpy(w.T.copy()),
                                        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (1, L, H, DH)
    _close_bf16(got, want)


def test_sla_linear_branch_bf16_against_jax_cpu_chain():
    """The linear branch's precision at bf16, a decided divergence: JAX off
    the TPU takes phi in bf16, rounds o_l to bf16 and applies proj_l in bf16
    (attention.py:261-266); the port runs K21 on every device (its plain
    version here), with phi, kv, kvw and the division in fp32 and one bf16
    rounding, as the TPU kernel computes. Both are held against the port's
    fp32 `sla_attention` on the same values: the port's mean error at most
    JAX's, and the two within atol 2e-2 + two bf16 steps of the largest
    value."""
    from turbodiffusion_tpu.ops import attention as attention_jax
    L = 300
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(_rand((1, L, H, DH), s, 2.0))
                                    for s in (20, 21, 22))
    w, b = _proj(23)
    attn = dict(backend="sla", sla_topk=0.5, block_q=64, block_k=64,
                linear_branch=True)
    want = _np(attention_jax.sla_attention(
        qj, kj, vj, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        AttentionConfigJax(**attn)))
    proj_l = torch.nn.Linear(DH, DH)
    with torch.no_grad():
        proj_l.weight.copy_(torch.from_numpy(w.T.copy()))
        proj_l.bias.copy_(torch.from_numpy(b))
        cfg = AttentionConfig(**attn)
        got = attention_port.sla_attention(qt, kt, vt, proj_l, cfg)
        ref = _np(attention_port.sla_attention(qt.float(), kt.float(),
                                               vt.float(), proj_l, cfg))
        lin = ref - _np(attention_port.sla_attention(
            qt.float(), kt.float(), vt.float(), proj_l,
            AttentionConfig(**{**attn, "linear_branch": False})))
    assert got.dtype == torch.bfloat16
    assert np.abs(lin).mean() > 0.1                   # the branch is felt
    err_port, err_jax = np.abs(_np(got) - ref).mean(), np.abs(want - ref).mean()
    assert err_port <= err_jax, (err_port, err_jax)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=ATOL + 2 * BF16_STEP * np.abs(want).max())


# ---------------------------------------------------------------------------
# 2-layer W8A8 forwards: v_quant="row", sla_block 64, batch 2
# ---------------------------------------------------------------------------

SIZE = dict(dim=256, ffn_dim=1536, num_heads=2)     # 2 x 128, BN 768


def _jax_init():
    """A parameter tree with the structure of the JAX init of the test DiT
    (SIZE, from jax.eval_shape: no compile) and seeded numpy values in its
    dtypes: linear weights N(0, 1/fan_in), norm scales 1 + 0.1 N, the rest
    0.1 N."""
    from turbodiffusion_tpu.models.wan import init_wan_params as init_jax
    cfg_j = wan_test_config_jax(
        attention=AttentionConfigJax(backend="sagesla"), dtype=jnp.bfloat16,
        **SIZE)
    shapes = jax.eval_shape(functools.partial(init_jax, cfg=cfg_j),
                            jax.random.PRNGKey(0))
    r = np.random.RandomState(0)

    def fill(path, s):
        a = r.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        if name == "w":
            a = a / np.sqrt(s.shape[-2])
        else:
            a = 1.0 + 0.1 * a if name == "scale" else 0.1 * a
        return a.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_params(linear_branch: bool):
    """The seeded tree, proj_l zero unless the linear branch is on."""
    params = _jax_init()
    r = np.random.RandomState(1)
    pl_ = params["blocks"]["self_attn"]["proj_l"]
    pl_["w"], pl_["b"] = np.zeros_like(pl_["w"]), np.zeros_like(pl_["b"])
    if linear_branch:
        pl_ = params["blocks"]["self_attn"]["proj_l"]
        pl_["w"] = (0.2 * r.randn(*pl_["w"].shape)).astype(np.float32)
        pl_["b"] = (0.2 * r.randn(*pl_["b"].shape)).astype(np.float32)
    return params


def _quantized_tree(params):
    q = dict(params)
    q["blocks"] = jax.tree.map(np.array, quant_jax.quantize_wan_blocks(
        jax.tree.map(jnp.asarray, params["blocks"]), mode="postscale",
        fuse_qkv=True))
    return q


def _patch_jax_tpu_branches(monkeypatch, fused: bool):
    """JAX's TPU branches on the CPU (test-only): the fused SageSLA branch
    forced on (fused) or the composable Pallas attention forced on (else),
    their Pallas entry points and the W8A8 GEMM in interpret mode."""
    import turbodiffusion_tpu.models.wan as wan_jax
    import turbodiffusion_tpu.ops.attention as attention_jax
    patches = [(quant_jax, "int8_gemm_postscale_pallas")]
    if fused:
        monkeypatch.setattr(wan_jax, "_use_fused_sla", lambda p, cfg: True)
        patches += [(attention_jax, "sla_attention_fused"),
                    (sf_jax, "unfold_quant")]
    else:
        monkeypatch.setattr(attention_jax, "_use_pallas", lambda *a: True)
        patches += [(fp_jax, "flash_attention")]
    for mod, name in patches:
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


@pytest.mark.parametrize("v_quant,block,linear_branch,batch", [
    ("row", 128, False, 1), ("row", 128, True, 1), ("channel", 64, False, 1),
    ("channel", 128, False, 2)])
def test_wan_forward_w8a8_sagesla_modes_match_jax(monkeypatch, v_quant, block,
                                                  linear_branch, batch):
    """WanModel.forward with W8A8 linears (dim 256, 2 heads x 128, ffn 1536,
    2 layers, 312 tokens, topk 0.7, bf16) against JAX `wan_forward` on the same
    quantised tree: the fused path at v_quant="row" (K5, K18, K19, and K21
    with the linear branch on); the composable path at blocks 64/64 (K2,
    K20); the fused channel path at batch 2 (the FFN off K10 -> K11, the O
    gate after the GEMM)."""
    import turbodiffusion_tpu.models.wan as wan_jax
    _patch_jax_tpu_branches(monkeypatch, fused=block >= 128)
    attn = dict(backend="sagesla", sla_topk=0.7, block_q=block,
                block_k=block, linear_branch=linear_branch, v_quant=v_quant)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn),
                                dtype=jnp.bfloat16, **SIZE)
    cfg_t = wan_test_config(attention=AttentionConfig(**attn),
                            dtype=torch.bfloat16, quant_linear=True, **SIZE)
    params = _jax_params(linear_branch)
    qtree = _quantized_tree(params)
    model = WanModel(cfg_t)
    quant.quantize_wan_blocks(model.blocks)
    load_jax_params(model, qtree)

    x = np.concatenate([_rand((1, 16, 3, 16, 26), 2 + i)   # 312 tokens
                        for i in range(batch)])
    t = np.full((batch, 1), 537.0, np.float32)
    ctx = np.concatenate([_rand((1, 16, 32), 3 + 5 * i) for i in range(batch)])

    def jax_fwd(tree):
        return np.asarray(wan_jax.wan_forward(
            jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(x),
            jnp.asarray(t), jnp.asarray(ctx)), np.float32)

    ref, want = jax_fwd(params), jax_fwd(qtree)
    calls = {}
    for mod, name in ((attention_port, "sparse_attention_i8_planes"),
                      (attention_port, "linear_projected_planes"),
                      (attention_port, "sparse_flash_attention_i8qk"),
                      (attention_port, "sparse_attention_i8_vt")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda fn_, n, *a, **k: calls.__setitem__(n, calls.get(n, 0) + 1)
            or fn_(*a, **k), fn, name))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).float().numpy()
    expect = ({"sparse_attention_i8_planes": 2} if v_quant == "row"
              else {"sparse_flash_attention_i8qk": 2} if block < 128
              else {"sparse_attention_i8_vt": 2})
    if linear_branch:
        expect["linear_projected_planes"] = 2
    assert calls == expect
    assert got.shape == want.shape == x.shape
    scale = np.abs(ref).max()
    err_jax = np.abs(want - ref).mean()
    err_port = np.abs(got - ref).mean()
    assert scale > 0.1 and err_jax > 1e-4          # live, and int8 is felt
    assert err_port <= 1.2 * err_jax + 1e-4, (err_port, err_jax)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
