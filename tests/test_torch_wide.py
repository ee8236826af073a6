"""The wide-model (Wan2.1-14B: dim 5120, 40 heads of 128) path of the port
against the JAX package: K15 (`row_rms_inv`), K5's external-RMS mode, K16
(wide `unfold_quant`), K17 (wide `cross_attention_qout`), the wide branch of
`sla_attention_fused`, and bf16 sagesla, sla and original blocks (K2 at
H*Dh 5120). The W8A8 block and forward are in test_torch_wide_w8a8.py,
which imports this file's helpers and test tree.

The kernels take their plain versions on CPU tensors; the JAX kernels run in
interpret mode, as the JAX package's own tests run them. Inputs are
numpy-seeded. Tolerances, with reasons:
  * K15: rtol 1e-6 (an fp32 mean of squares summed in another order);
  * K5 external-RMS against the JAX kernel: one bf16 step of the plane's
    largest value, int8 within 1 LSB, scales rtol 2^-7, pooled means atol
    4e-3 (XLA's excess precision, ROADMAP Queue C); against the port's own
    in-row RMS: equal (the same fp32 statistic);
  * K16: int8 and scales bitwise equal (the wide TPU kernel's rule, y /
    scale, on the same fp32 values);
  * K17: int8 within 1 LSB, scales rtol 5e-3 (K14's rule: fp32 sums in
    another order move a few bf16 roundings of P);
  * `sla_attention_fused` at width 5120: atol 2e-2 on values ~1 (PR 2's
    fused-path tolerance: bf16 output, bf16 rounding of p);
  * the bf16 blocks: atol 2^-6 * max |y| (the W8A8 block rule of
    test_torch_int8_feeds.py: bf16 outputs; fused sagesla's int8 Q and K
    one LSB apart where XLA's excess precision moves a bf16 step, ROADMAP
    Queue C), against JAX with its TPU branches taken (the backend reported
    as "tpu", every Pallas entry point in interpret mode, its calls
    counted), `_rmsrope_pallas` among them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turbodiffusion_tpu.models.wan as wan_jax
import turbodiffusion_tpu.ops.attention as attention_jax
import turbodiffusion_tpu.ops.flash_pallas as flash_pallas_jax
from turbodiffusion_tpu import config as config_jax
from turbodiffusion_tpu.ops import fused_norm as fused_norm_jax
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu.ops import sla_fused as sla_fused_jax
from turbodiffusion_tpu_torch import config as config_t
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops.attention import sla_attention_fused
from turbodiffusion_tpu_torch.ops.fused_norm import rope_cos_sin_full
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

H, DH = 40, 128
HD = H * DH                                       # 5120, the 14B's dim
EPS = 1e-6
BF16_RTOL = 2.0 ** -7                             # one bf16 step
K17_SCALE_RTOL = 5e-3
GRID = (2, 8, 16)                                 # 256 tokens


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


def _tables(L, Lp):
    """Rotate-half tables of GRID cut to L rows; the JAX copies padded to
    Lp (its BlockSpec reads Lp rows)."""
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(*GRID, DH))
    cosF, sinF = cosF[:L], sinF[:L]
    pad = ((0, Lp - L), (0, 0))
    return (cosF, sinF), (jnp.asarray(np.pad(cosF.numpy(), pad)),
                          jnp.asarray(np.pad(sinF.numpy(), pad)))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_14b_preset_matches_jax():
    """`wan_config("Wan2.1-14B")` equals the JAX preset field by field (the
    public Wan-AI/Wan2.1-T2V-14B shape: dim 5120, 40 x 128, 40 layers, FFN
    13824); the dtype compares by name, the attention config by field."""
    got, want = config_t.wan_config("Wan2.1-14B"), \
        config_jax.wan_config("Wan2.1-14B")
    names = [f.name for f in dataclasses.fields(got)]
    assert set(names) <= {f.name for f in dataclasses.fields(want)}
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif name == "attention":
            for f in dataclasses.fields(a):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        else:
            assert a == b, name
    assert (got.dim, got.num_heads, got.head_dim, got.num_layers,
            got.ffn_dim) == (5120, 40, 128, 40, 13824)
    assert quant.pick_bn_div(got.ffn_dim) == 768


def test_cli_refuses_14b_without_w8a8_sagesla_on_the_card(monkeypatch):
    """Nothing is refused any more: `--model Wan2.1-14B` on `cuda` reaches
    WanPipeline.create with bf16 or W8A8 linears and `sagesla`, `sla` or
    `original` attention, at 480p and 720p; on the CPU too. The name is
    kept from when the CLI refused the bf16 forms on the card; the test
    now holds that none is refused."""
    from turbodiffusion_tpu_torch.inference.wan2_1_t2v import main
    from turbodiffusion_tpu_torch.pipelines import pipeline
    seen = []

    def create(**kw):
        seen.append((kw["model"], kw["quant_linear"], kw["attention_type"],
                     kw["device"]))
        raise SystemExit(0)

    monkeypatch.setattr(pipeline.WanPipeline, "create", staticmethod(create))
    base = ["--model", "Wan2.1-14B", "--random_weights", "--prompt", "x"]
    want = []
    for device in ("cuda", "cpu"):
        for attention in ("sagesla", "sla", "original"):
            for extra in ([], ["--quant_linear"], ["--resolution", "720p"]):
                with pytest.raises(SystemExit):
                    main(base + ["--device", device, "--attention_type",
                                 attention] + extra)
                want.append(("Wan2.1-14B", extra == ["--quant_linear"],
                             attention, device))
    assert seen == want


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,col_block", [(None, 0), (HD, 2)])
def test_k15_plain_matches_jax(width, col_block):
    """(1, 300, 5120), and the third 5120-column block of a 15360-wide
    input read through `width` / `col_block`."""
    cols = HD if width is None else 3 * HD
    xj, xt = _bf16(_rand((1, 300, cols), 1, 2.0))
    want = sla_fused_jax.row_rms_inv(xj, EPS, width=width, col_block=col_block,
                                     interpret=True)
    got = sf.row_rms_inv(xt, EPS, width=width, col_block=col_block)
    assert got.dtype == torch.float32 and got.shape == (1, 300, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# K5, external-RMS mode
# ---------------------------------------------------------------------------

# (norm + rope, pool, quant, bf16 plane): the fused path's Q and K calls
K5_FORMS = {"q": (128, True, False), "k": (256, False, True)}


@pytest.mark.parametrize("form", sorted(K5_FORMS))
def test_k5_external_rms_plain_matches_jax(form):
    """40 heads, L = 256 padded to 512, the RMS inverse from row_rms_inv
    (JAX: `head_planes(..., rms_inv=...)` in one 40-head launch)."""
    pool, quant_, bf16_out = K5_FORMS[form]
    L, Lp = 256, 512
    xj, xt = _bf16(_rand((1, L, HD), 2))
    wj, wt = _bf16(1 + _rand((HD,), 3, 0.1))
    (ct, st), (cj, sj) = _tables(L, Lp)
    kw = dict(num_heads=H, eps=EPS, pool=pool, quant=quant_, bf16_out=bf16_out,
              pad_to=Lp)
    ri_j = sla_fused_jax.row_rms_inv(xj, EPS, interpret=True)
    want = sla_fused_jax.head_planes(
        xj, wj, cj, sj, rms_inv=jnp.pad(ri_j, ((0, 0), (0, Lp - L), (0, 0))),
        interpret=True, **kw)
    got = sf.head_planes(xt, wt, ct, st, rms_inv=sf.row_rms_inv(xt, EPS), **kw)
    assert sorted(got) == sorted(want)
    if bf16_out:
        w16 = _np(want["bf16"])[:, :, :L]
        np.testing.assert_allclose(_np(got["bf16"])[:, :, :L], w16, rtol=0,
                                   atol=BF16_RTOL * np.abs(w16).max())
    if quant_:
        _int8_close(got["i8"][:, :, :L].numpy(), np.asarray(want["i8"])[:, :, :L])
        np.testing.assert_allclose(got["scale"][:, :, :L].numpy(),
                                   np.asarray(want["scale"])[:, :, :L],
                                   rtol=BF16_RTOL)
    assert got["pooled"].shape == (1, H, L // pool, DH)
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]),
                               atol=4e-3)


def test_k5_external_rms_equals_the_in_row_rms():
    """The statistic K15 hands K5 is the one K5's in-row mode computes: the
    two plain forms give equal outputs (40 heads, every output)."""
    L, Lp = 200, 512
    x = torch.from_numpy(_rand((1, L, HD), 4)).bfloat16()
    w = (1 + torch.from_numpy(_rand((HD,), 5, 0.1))).bfloat16()
    (ct, st), _ = _tables(L, Lp)
    kw = dict(num_heads=H, eps=EPS, pool=128, quant=True, bf16_out=True,
              pad_to=Lp)
    ext = sf.head_planes(x, w, ct, st, rms_inv=sf.row_rms_inv(x, EPS), **kw)
    own = sf.head_planes(x, w, ct, st, **kw)
    assert sorted(ext) == sorted(own)
    for key in own:
        assert torch.equal(ext[key], own[key]), key


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------

def test_k16_plain_matches_jax_bitwise():
    """Planes (1, 40, 512, 128) to 504 live rows: the JAX function's two
    wide passes, and the port's `unfold_quant` dispatching to K16's plain
    version (y / scale) at H*Dh 5120."""
    pj, pt = _bf16(_rand((1, H, 512, DH), 6, 1.5))
    want_q, want_s = sla_fused_jax.unfold_quant(pj, 504, interpret=True)
    got_q, got_s = sf.unfold_quant(pt, 504)
    assert got_q.shape == (1, 504, HD) and got_s.shape == (1, 504, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    wide_q, wide_s = sf.unfold_quant_wide_plain(pt, 504)
    assert torch.equal(got_q, wide_q) and torch.equal(got_s, wide_s)


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------

def test_k17_plain_matches_jax():
    """JAX `_cross_attention_qout_wide`, fused-norm mode, at Lq 300, 77 text
    keys, 40 heads; the port's `cross_attention_qout` takes K15 + K17's plain
    versions at that width."""
    Lq, Lk = 300, 77
    (qj, qt), (kj, kt), (vj, vt) = (
        _bf16(_rand(shape, 10 + i)) for i, shape in
        enumerate([(1, Lq, HD), (1, Lk, H, DH), (1, Lk, H, DH)]))
    nwj, nwt = _bf16(1 + _rand((HD,), 13, 0.2))
    want_q, want_s = flash_pallas_jax._cross_attention_qout_wide(
        qj, kj, vj, nwj, DH ** -0.5, EPS, interpret=True)
    got_q, got_s = fa.cross_attention_qout(qt, kt, vt, nwt, eps=EPS)
    assert got_q.shape == (1, Lq, HD) and got_s.shape == (1, Lq, 1)
    _int8_close(got_q.numpy(), want_q)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=K17_SCALE_RTOL)
    plain = fa.cross_attention_qout_wide_plain(
        qt, sf.row_rms_inv_plain(qt, EPS), kt, vt, nwt)
    assert torch.equal(got_q, plain[0]) and torch.equal(got_s, plain[1])


# ---------------------------------------------------------------------------
# sla_attention_fused at width 5120
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topk", [1.0, 0.5])
def test_sla_attention_fused_wide_matches_jax(topk):
    """L = 256 (Lp 512), blocks 128, the linear branch off: K15 on Q and
    K, K5 in its external-RMS mode at 40 heads, K6, K7; JAX tiles the
    front end over two head groups of 20."""
    L, Lp = 256, 512
    xs = [_bf16(_rand((1, L, HD), s)) for s in (20, 21, 22)]
    wq, wk = _bf16(1 + _rand((HD,), 23, 0.1)), _bf16(1 + _rand((HD,), 24, 0.1))
    (ct, st), _ = _tables(L, Lp)
    kw = dict(backend="sagesla", sla_topk=topk, block_q=128, block_k=128,
              linear_branch=False, v_quant="channel")
    want = attention_jax.sla_attention_fused(
        *[x[0] for x in xs], wq[0], wk[0],
        (jnp.asarray(ct.numpy()), jnp.asarray(st.numpy())), None,
        config_jax.AttentionConfig(**kw), num_heads=H, eps=EPS, interpret=True)
    with torch.no_grad():
        got = sla_attention_fused(*[x[1] for x in xs], wq[1], wk[1], (ct, st),
                                  None, config_t.AttentionConfig(**kw),
                                  num_heads=H, eps=EPS)
    assert got.shape == want.shape == (1, H, Lp, DH)
    g, w_ = _np(got)[:, :, :L], _np(want)[:, :, :L]
    assert np.abs(w_).max() > 0.1
    np.testing.assert_allclose(g, w_, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# JAX with its TPU branches on the CPU, and the 5120-wide test tree
# ---------------------------------------------------------------------------

SIZE = dict(dim=HD, ffn_dim=1536, num_heads=H)    # FFN BN 768, as at 14B
ATTN = dict(backend="sagesla", sla_topk=0.5, block_q=128, block_k=128,
            linear_branch=False)


def _force(fn_, calls, name):
    """A JAX entry point run in interpret mode whatever its caller asks,
    counting its calls under `name`."""
    @functools.wraps(fn_)
    def run(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn_(*args, **{**kwargs, "interpret": True})
    return run


def _count(fn_, calls, name):
    @functools.wraps(fn_)
    def run(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn_(*args, **kwargs)
    return run


def _patch_tpu_jax(monkeypatch, calls, clear: bool = True):
    """JAX as it runs on the TPU, on the CPU (test-only): the backend
    reported as "tpu", so wan_block takes its fused and qout branches, and
    every Pallas entry point the block reaches in interpret mode, its calls
    counted in `calls` (the wide unfold's two kernel bodies and the wide
    cross kernel counted where the jitted callers trace them, after the
    compile caches are cleared; clear=False keeps what earlier tests
    compiled, for a caller that counts only entry points called from
    Python)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention_jax, "_use_pallas", lambda *a, **k: False)
    for mod, name in ((fused_norm_jax, "_mln_pallas"),
                      (attention_jax, "sla_attention_fused"),
                      (sla_fused_jax, "row_rms_inv"),
                      (sla_fused_jax, "unfold_quant"),
                      (flash_pallas_jax, "cross_attention_qout"),
                      (quant_jax, "quantize_rows_int8_pallas"),
                      (quant_jax, "int8_gemm_postscale_pallas"),
                      (quant_jax, "int8_gemm_postscale_qout_pallas"),
                      (quant_jax, "int8_gemm_blockact_pallas")):
        monkeypatch.setattr(mod, name, _force(getattr(mod, name), calls, name))
    for mod, name in ((sla_fused_jax, "_unfold_scale_kernel"),
                      (sla_fused_jax, "_unfold_write_kernel"),
                      (flash_pallas_jax, "_cross_attention_qout_wide")):
        monkeypatch.setattr(mod, name, _count(getattr(mod, name), calls, name))
    if clear:
        jax.clear_caches()      # the jitted callers trace the counted bodies


def _spy_port(monkeypatch, calls):
    """Count the port's wide plain versions as the CPU reaches them."""
    for mod, name in ((sf, "row_rms_inv_plain"), (sf, "unfold_quant_wide_plain"),
                      (fa, "cross_attention_qout_wide_plain"),
                      (sf, "unfold_quant_plain"),
                      (fa, "cross_attention_qout_plain")):
        monkeypatch.setattr(mod, name, _count(getattr(mod, name), calls, name))


@pytest.fixture(scope="module")
def wide_tree():
    """The JAX config and a 2-layer bf16 JAX tree at SIZE, as numpy (the
    head drawn N(0, 0.02^2)): the 5120-wide init is most of the W8A8 and
    bf16 tests' time, so they share it."""
    from turbodiffusion_tpu.models.wan import init_wan_params as init_jax
    cfg_j = config_jax.wan_test_config(
        attention=config_jax.AttentionConfig(**ATTN), dtype=jnp.bfloat16,
        num_layers=2, **SIZE)
    params = jax.tree.map(np.array, jax.jit(init_jax, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))
    head = params["head"]["head"]
    head["w"] = (0.02 * np.random.RandomState(1).randn(
        *head["w"].shape)).astype(np.float32)
    return cfg_j, params


# ---------------------------------------------------------------------------
# bf16 blocks (sagesla, sla, original) against JAX with its TPU branches:
# K2 at 5120 on the cross q, and on the self q / k outside fused sagesla
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_block(wide_tree):
    """Layer 0 of `wide_tree` as a port block (bf16 linears, with proj_l;
    the rest of the model stays on the meta device) and as a JAX block."""
    _, params = wide_tree
    cfg_t = config_t.wan_test_config(
        attention=config_t.AttentionConfig(**ATTN), dtype=torch.bfloat16,
        num_layers=1, **SIZE)
    blk = WanModel(cfg_t, device="meta").blocks[0].to_empty(device="cpu")
    block0 = jax.tree.map(lambda a: a[0], params["blocks"])
    load_jax_params(blk, block0)
    return blk, jax.tree.map(jnp.asarray, block0)


# per block, JAX with its TPU branches: K1 x 3, then K2 on the cross q and,
# outside fused sagesla, on the self q and k; fused sagesla takes K15 first
# on Q and K (the wide form)
JAX_BF16_CALLS = {
    "sagesla": {"_mln_pallas": 3, "_rmsrope_pallas": 1, "row_rms_inv": 2,
                "sla_attention_fused": 1},
    "sla": {"_mln_pallas": 3, "_rmsrope_pallas": 3},
    "dense": {"_mln_pallas": 3, "_rmsrope_pallas": 3},
}


@pytest.mark.parametrize("backend", sorted(JAX_BF16_CALLS))
def test_bf16_wide_block_matches_jax_wan_block(monkeypatch, bf16_block, backend):
    """WanAttentionBlock at dim 5120, 40 heads, bf16 linears, 256 tokens, as
    the 14B's bf16 forms run it, against JAX `wan_block` on its TPU branches
    (`_rmsrope_pallas` in interpret mode at H*Dh 5120, counted); the port's
    K2 plain version runs as often."""
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    attn = {**ATTN, "backend": backend}
    cfg_j = config_jax.wan_test_config(
        attention=config_jax.AttentionConfig(**attn), dtype=jnp.bfloat16,
        num_layers=1, **SIZE)
    cfg_t = config_t.wan_test_config(
        attention=config_t.AttentionConfig(**attn), dtype=torch.bfloat16,
        num_layers=1, **SIZE)
    blk, block_j = bf16_block
    for m in blk.modules():       # one set of weights, this attention
        if hasattr(m, "cfg"):
            monkeypatch.setattr(m, "cfg", cfg_t)
    n = int(np.prod(GRID))
    x, e0, ctx = _rand((1, n, HD), 60), _rand((1, 6, HD), 61, 0.1), \
        _rand((1, 16, HD), 62)
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(*GRID, DH))

    port_calls = {}
    monkeypatch.setattr(fn, "_rmsrope_plain",
                        _count(fn._rmsrope_plain, port_calls, "_rmsrope_plain"))
    with torch.no_grad():
        got = blk(torch.from_numpy(x).bfloat16(), torch.from_numpy(e0),
                              (cosF, sinF), torch.from_numpy(ctx).bfloat16()
                              ).float().numpy()
    assert port_calls == {"_rmsrope_plain": JAX_BF16_CALLS[backend]["_rmsrope_pallas"]}

    # every entry point counted here is called from Python (wan_block runs
    # eagerly), so the caches are kept: fused sagesla reuses the kernels
    # test_sla_attention_fused_wide_matches_jax[0.5] compiled at these
    # shapes
    jax_calls, widths = {}, []
    _patch_tpu_jax(monkeypatch, jax_calls, clear=False)
    rmsrope = fused_norm_jax._rmsrope_pallas

    def rmsrope_width(x, *a, **k):
        widths.append(k.get("width") or x.shape[-1])
        return rmsrope(x, *a, **k)

    monkeypatch.setattr(fused_norm_jax, "_rmsrope_pallas", _force(
        rmsrope_width, jax_calls, "_rmsrope_pallas"))
    want = np.asarray(wan_jax.wan_block(
        block_j, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e0),
        (jnp.asarray(cosF.numpy()), jnp.asarray(sinF.numpy())),
        jnp.asarray(ctx, jnp.bfloat16), cfg_j), np.float32)
    assert jax_calls == JAX_BF16_CALLS[backend], jax_calls
    assert widths and set(widths) == {HD}          # the TPU kernel at 5120
    assert got.shape == want.shape == (1, n, HD)
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * scale)
