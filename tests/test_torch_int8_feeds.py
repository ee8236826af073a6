"""The int8 feeds of the W8A8 path (K12, K13, K14) against the JAX package.

K12 (quant-out modulated LayerNorm), K13 (`unfold_quant`) and K14
(`cross_attention_qout`, fused-norm mode) take their plain versions on CPU
tensors; the JAX kernels run in interpret mode, as the JAX package's own
tests run them. Inputs are numpy-seeded: L = 300 (a ragged tail), D = 256,
heads of 128, 77 text keys (so the kv_len mask bites). Tolerances, with
reasons:
  * K12: int8 at most 1 LSB and fp32 scales rtol 1e-5 (the LN statistics
    are fp32 sums in another order; 0 LSB and 1.2e-7 seen);
  * K13: bitwise equal to the JAX kernel and to K8's plain version over
    `unfold_planes` (the same fp32 rule on the same bf16 values);
  * K14: int8 at most 1 LSB, fp32 scales rtol 5e-3: the row's mean square
    is an fp32 sum in another order, which can move one bf16 element of the
    normed q by a step (2^-8), and the QK and P V sums too, which moves the
    bf16 rounding of a few P elements; either moves that row's output and
    its absmax by up to ~p_j * 2^-8 / l (5.3e-4 seen in one row of 300, most
    rows within 1e-6; the same bound holds the kernel on the card). K14
    is also held against the JAX planes form fed by `rmsnorm_rope_ref`, as
    tests/test_attention.py:460 holds the JAX kernel: interpret mode on the
    CPU could otherwise hide a bf16 rounding of `(x * rms) * w` (the excess
    precision ROADMAP Queue C records for `head_planes`);
  * one W8A8 block (dim 256, 2 heads, FFN 1536, 520 tokens) against JAX
    `wan_block` with its qout branches taken (the backend reported as
    "tpu", every Pallas kernel it reaches in interpret mode, the composable
    `sla` attention through JAX's jnp reference): atol 2^-6 * max |y| on
    the block output (bf16 outputs and int8 values one LSB apart upstream
    of a GEMM).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
from turbodiffusion_tpu.ops import fused_norm as fused_norm_jax
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu.ops import sla_fused as sla_fused_jax
from turbodiffusion_tpu.ops.flash_pallas import (
    cross_attention_qout as cross_attention_qout_jax)
from turbodiffusion_tpu_torch.config import AttentionConfig, wan_test_config
from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import fused_norm as fn
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

L, D, DH, TEXT = 300, 256, 128, 77
EPS = 1e-6
K14_SCALE_RTOL = 5e-3


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["mod", "affine"])
def test_k12_plain_matches_jax(form):
    """norm1 / norm2 (AdaLN modulation, int8 from the fp32 modulated value)
    and norm3 (weight and bias, int8 from the bf16 value)."""
    xj, xt = _bf16(_rand((1, L, D), 1, 2.0))
    if form == "mod":
        ms, mb = _rand((1, 1, D), 2, 0.3), _rand((1, 1, D), 3, 0.3)
        want = fused_norm_jax.modulated_layer_norm(
            xj, jnp.asarray(ms), jnp.asarray(mb), eps=EPS, interpret=True,
            quant_out=True)
        got = fn.modulated_layer_norm(xt, torch.from_numpy(ms),
                                      torch.from_numpy(mb), eps=EPS,
                                      quant_out=True)
    else:
        (wj, wt), (bj, bt) = _bf16(1 + _rand((D,), 4, 0.1)), \
            _bf16(_rand((D,), 5, 0.1))
        want = fused_norm_jax.modulated_layer_norm(
            xj, weight=wj, bias=bj, eps=EPS, interpret=True, quant_out=True)
        got = fn.modulated_layer_norm(xt, weight=wt, bias=bt, eps=EPS,
                                      quant_out=True)
    assert got[0].dtype == torch.int8 and got[0].shape == (1, L, D)
    assert got[1].dtype == torch.float32 and got[1].shape == (1, L, 1)
    _int8_close(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [2, 3])
def test_k13_plain_matches_jax_bitwise(heads):
    """Planes (B, H, 512, 128) padded from L = 300 live rows."""
    pj, pt = _bf16(_rand((1, heads, 512, DH), 9, 1.5))
    want_q, want_s = sla_fused_jax.unfold_quant(pj, L, interpret=True)
    got_q, got_s = sf.unfold_quant(pt, L)
    assert got_q.shape == (1, L, heads * DH) and got_s.shape == (1, L, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    k8_q, k8_s = quant.quantize_rows_int8_plain(sf.unfold_planes(pt, L))
    assert torch.equal(got_q, k8_q) and torch.equal(got_s, k8_s)


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------

def _k14_inputs(heads, seed):
    HD = heads * DH
    (qj, qt), (kj, kt), (vj, vt) = (
        _bf16(_rand(shape, seed + i)) for i, shape in
        enumerate([(1, L, HD), (1, TEXT, heads, DH), (1, TEXT, heads, DH)]))
    nwj, nwt = _bf16(1 + _rand((HD,), seed + 3, 0.2))
    return (qj, kj, vj, nwj), (qt, kt, vt, nwt)


def _k14_close(got, want_q, want_s):
    _int8_close(got[0].numpy(), want_q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_s),
                               rtol=K14_SCALE_RTOL)


@pytest.mark.parametrize("heads", [2, 3])
def test_k14_plain_matches_jax(heads):
    (qj, kj, vj, nwj), (qt, kt, vt, nwt) = _k14_inputs(heads, 10)
    want_q, want_s = cross_attention_qout_jax(qj, kj, vj, norm_w=nwj, eps=EPS,
                                              interpret=True)
    got = fa.cross_attention_qout(qt, kt, vt, nwt, eps=EPS)
    assert got[0].shape == (1, L, heads * DH) and got[1].shape == (1, L, 1)
    _k14_close(got, want_q, want_s)


@pytest.mark.parametrize("heads", [2, 3])
def test_k14_plain_matches_the_jax_planes_form(heads):
    """The JAX planes form of the same kernel fed by the jnp norm reference
    (rmsnorm_rope_ref with identity RoPE tables): the port's norm is that
    reference within one bf16 step, and its attention + int8 feed the
    kernel's."""
    from turbodiffusion_tpu.ops.fused_norm import rmsnorm_rope_ref
    from turbodiffusion_tpu_torch.models.layers import rms_norm
    (qj, kj, vj, nwj), (qt, kt, vt, nwt) = _k14_inputs(heads, 20)
    qn = rmsnorm_rope_ref(qj, nwj, jnp.ones((L, DH), jnp.float32),
                          jnp.zeros((L, DH), jnp.float32), EPS)
    np.testing.assert_allclose(
        rms_norm(qt, nwt, eps=EPS).float().numpy(),
        np.asarray(qn, np.float32).reshape(1, L, heads * DH), rtol=2.0 ** -7)
    want_q, want_s = cross_attention_qout_jax(qn, kj, vj, interpret=True)
    _k14_close(fa.cross_attention_qout(qt, kt, vt, nwt, eps=EPS), want_q,
               want_s)


def test_int8_feed_wrappers_refuse_non_cuda_devices():
    """A tensor on neither the CPU nor a card (meta) raises: no plain
    fallback off the CPU."""
    x = torch.zeros(1, 8, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn.modulated_layer_norm(x, quant_out=True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sf.unfold_quant(torch.zeros(1, 2, 64, DH, device="meta"), 8)
    k = torch.zeros(1, TEXT, 2, DH, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.cross_attention_qout(x, k, k, torch.zeros(D, device="meta"))


def test_k14_head_groups():
    """K14's blocks: the most heads per block, up to 4, that keeps a cluster
    at 8 blocks or fewer, else the least that does (1.3B: 12 heads as 3
    blocks of 4; 14B: 40 as 8 of 5)."""
    assert [fa._qout_group(h) for h in (2, 3, 8, 12, 16, 40)] == \
        [2, 3, 4, 4, 4, 5]


# ---------------------------------------------------------------------------
# one W8A8 block against JAX wan_block with its qout branches
# ---------------------------------------------------------------------------

SIZE = dict(dim=D, ffn_dim=1536, num_heads=2, num_layers=1)
GRID = (5, 8, 13)                                   # 520 tokens


def _force(fn_, calls, name):
    """A Pallas entry point run in interpret mode whatever its caller asks,
    counting its calls under `name`."""
    @functools.wraps(fn_)
    def run(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn_(*args, **{**kwargs, "interpret": True})
    return run


def _patch_tpu_jax(monkeypatch, calls):
    """JAX as it runs on the TPU, on the CPU (test-only): the backend
    reported as "tpu", so wan_block takes its qout branches, and every
    Pallas entry point the block reaches in interpret mode, its calls
    counted in `calls`; the composable sparse attention takes its jnp
    reference."""
    import turbodiffusion_tpu.ops.attention as attention_jax
    import turbodiffusion_tpu.ops.flash_pallas as flash_pallas_jax
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention_jax, "_use_pallas", lambda *a, **k: False)
    for mod, name in ((fused_norm_jax, "_mln_pallas"),
                      (fused_norm_jax, "_rmsrope_pallas"),
                      (attention_jax, "sla_attention_fused"),
                      (sla_fused_jax, "unfold_quant"),
                      (flash_pallas_jax, "cross_attention_qout"),
                      (quant_jax, "quantize_rows_int8_pallas"),
                      (quant_jax, "int8_gemm_postscale_pallas"),
                      (quant_jax, "int8_gemm_postscale_qout_pallas"),
                      (quant_jax, "int8_gemm_blockact_pallas")):
        monkeypatch.setattr(mod, name, _force(getattr(mod, name), calls, name))


def _spy(calls, name, fn_):
    """fn_, counting its calls under `name`; an int8-out LN counts as K12."""
    def run(*args, **kwargs):
        key = "K12" if kwargs.get("quant_out") else name
        calls[key] = calls.get(key, 0) + 1
        return fn_(*args, **kwargs)
    return run


@pytest.mark.parametrize("backend", ["sagesla", "sla"])
def test_w8a8_block_matches_jax_wan_block(monkeypatch, backend):
    """WanAttentionBlock with W8A8 linears (fused QKV) loaded from a JAX
    tree quantised by quantize_wan_blocks, against JAX `wan_block` on the
    same tree taking its int8 feeds: both run the same kernel composition
    (sagesla: K12 x3, K9, K5-K7, K13, K14, K10, K11; sla: K12 x3, K2, K3,
    K8 + K9 for O, K14, K10, K11)."""
    import turbodiffusion_tpu.models.wan as wan_jax
    from turbodiffusion_tpu.models.wan import init_wan_params as init_jax
    from turbodiffusion_tpu_torch.models import wan as wan_t
    from turbodiffusion_tpu_torch.ops.fused_norm import rope_cos_sin_full
    attn = dict(backend=backend, sla_topk=0.5, block_q=128, block_k=128,
                linear_branch=False)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn),
                                dtype=jnp.bfloat16, **SIZE)
    cfg_t = wan_test_config(attention=AttentionConfig(**attn),
                            dtype=torch.bfloat16, quant_linear=True, **SIZE)
    params = jax.tree.map(np.array, jax.jit(init_jax, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))
    qtree = dict(params)
    qtree["blocks"] = jax.tree.map(np.array, quant_jax.quantize_wan_blocks(
        jax.tree.map(jnp.asarray, params["blocks"]), mode="postscale",
        fuse_qkv=True))
    model = WanModel(cfg_t)
    quant.quantize_wan_blocks(model.blocks)
    load_jax_params(model, qtree)
    blk = model.blocks[0]

    n = int(np.prod(GRID))
    x = _rand((1, n, D), 40)
    e0 = _rand((1, 6, D), 41, 0.1)
    ctx = _rand((1, 16, D), 42)
    cosF, sinF = rope_cos_sin_full(rope_freqs_3d(*GRID, DH))

    calls = {}
    for name, label in (("unfold_quant", "K13"), ("cross_attention_qout", "K14"),
                        ("modulated_layer_norm", "LN"), ("rmsnorm_rope", "K2"),
                        ("quantize_rows_int8", "K8")):
        monkeypatch.setattr(wan_t, name, _spy(calls, label, getattr(wan_t, name)))
    with torch.no_grad():
        got = blk(torch.from_numpy(x).bfloat16(), torch.from_numpy(e0),
                  (cosF, sinF), torch.from_numpy(ctx).bfloat16())
    got = got.float().numpy()
    want_calls = ({"K12": 3, "K13": 1, "K14": 1} if backend == "sagesla"
                  else {"K12": 3, "K2": 2, "K14": 1})
    assert calls == want_calls, calls

    jax_calls = {}
    _patch_tpu_jax(monkeypatch, jax_calls)
    block_j = jax.tree.map(lambda a: jnp.asarray(a[0]), qtree["blocks"])
    want = np.asarray(wan_jax.wan_block(
        block_j, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e0),
        (jnp.asarray(cosF.numpy()), jnp.asarray(sinF.numpy())),
        jnp.asarray(ctx, jnp.bfloat16), cfg_j), np.float32)
    # JAX took its int8 feeds: 3 quant-out LNs, cross_attention_qout, the
    # FFN's int8 hidden; K8 only for the text K / V (and sla's O)
    fused = backend == "sagesla"
    assert jax_calls == {
        "_mln_pallas": 3, "cross_attention_qout": 1,
        "int8_gemm_postscale_pallas": 6, "int8_gemm_postscale_qout_pallas": 1,
        "int8_gemm_blockact_pallas": 1,
        "quantize_rows_int8_pallas": 2 if fused else 3,
        **({"sla_attention_fused": 1, "unfold_quant": 1} if fused
           else {"_rmsrope_pallas": 2})}, jax_calls
    assert got.shape == want.shape == (1, n, D)
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * scale)
