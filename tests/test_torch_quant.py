"""The W8A8 linears of the PyTorch port against the JAX package.

K8 (row quantiser), K9 (postscale GEMM), K10 (quant-out GEMM) and K11
(block-activation GEMM) take their plain versions on CPU tensors; the JAX
kernels run in interpret mode. Inputs are numpy-seeded. Tolerances, with
reasons:
  * int8 outputs at most 1 LSB (a value on a rounding boundary after fp32
    arithmetic in another order); fp32 scales rtol 1e-6 (the same fp32
    expression, the amax exact);
  * GEMM outputs in fp32 rtol 1e-5 + atol 1e-4: the int32 product is exact
    on both sides and the epilogue is the same fp32 expression, but XLA may
    fuse or reorder it (GELU's tanh, the slab sum of K11);
  * the weight quantiser and `quantize_wan_blocks`: bitwise equal;
  * the tiny W8A8 DiT (bf16): JAX on the CPU quantises every linear input
    with the jnp `quantize_rows_int8` (a multiply in bf16, per-row hidden
    scales); the port with its K8 (fp32) and the per-BN hidden scales of
    K10 / K11. Both are held against the unquantised forward: the port's
    mean error is at most 1.2x JAX's plus 1e-4 (the criterion of
    tests/test_quant.py::test_ffn_int8_chain_matches_unfused), and the two
    differ by at most 2% of the largest velocity (int8 noise through two
    blocks and the seeded head: 0.29-0.35% seen; the int8 error against the
    unquantised forward is ~1.7e-3-2.9e-3 mean in both packages);
  * one W8A8 FFN against the composition of the JAX interpret-mode kernels
    (K8, K10, K11): one bf16 step of the output (atol 2^-7 * max |y|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu_torch.config import AttentionConfig, wan_test_config
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.ops.fused_norm import _row_stride
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

M, K, N = 200, 256, 384          # an M tail: 200 is no multiple of 64 or 128


def _rand(shape, seed, std=1.0):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


def _int8(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()


def _operands(m, k, n, seed):
    """int8 activation and weight with their scales; the weight as JAX
    stores it (K, N) and as the port does (N, K)."""
    xq = _int8((m, k), seed)
    rs = np.abs(_rand((m, 1), seed + 1, 0.01)) + 1e-3
    wq = _int8((k, n), seed + 2)
    cs = np.abs(_rand((n,), seed + 3, 0.01)) + 1e-3
    return xq, rs, wq, cs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(200, 256), (8, 1536)])
def test_k8_plain_matches_jax(m, k):
    x = torch.from_numpy(_rand((m, k), 1, 3.0)).bfloat16()
    want_q, want_s = quant_jax.quantize_rows_int8_pallas(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), interpret=True)
    got_q, got_s = quant.quantize_rows_int8(x)
    assert got_q.dtype == torch.int8 and got_s.shape == (m, 1)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    _int8_close(got_q.numpy(), want_q)


def test_weight_quantiser_matches_jax():
    """Bitwise: the same scales and int8 from the same bf16 weights, the
    port on the transposed (out, in) layout."""
    w = torch.from_numpy(_rand((K, N), 2, 0.05)).bfloat16()
    want_q, want_s = quant_jax.quantize_int8_postscale(
        jnp.asarray(w.float().numpy(), jnp.bfloat16))
    got_q, got_s = quant.quantize_int8_postscale(w.t())
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# K9-K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tail", "bias", "gelu", "gate_residual"])
def test_k9_plain_matches_jax(case):
    xq, rs, wq, cs = _operands(M, K, N, 3)
    bias = _rand((N,), 7, 0.5) if case != "tail" else None
    act = "gelu_tanh" if case == "gelu" else None
    gate = _rand((N,), 8) if case == "gate_residual" else None
    res = _rand((M, N), 9) if case == "gate_residual" else None
    want = quant_jax.int8_gemm_postscale_pallas(
        jnp.asarray(xq), jnp.asarray(rs), jnp.asarray(wq), jnp.asarray(cs),
        bias=None if bias is None else jnp.asarray(bias), act=act,
        has_bias=bias is not None, out_dtype=jnp.float32, interpret=True,
        gate=None if gate is None else jnp.asarray(gate),
        residual=None if res is None else jnp.asarray(res))
    opt = lambda a: None if a is None else _t(a)         # noqa: E731
    got = quant.int8_gemm_postscale(_t(xq), _t(rs), _t(wq.T), _t(cs),
                                    opt(bias), act, opt(gate), opt(res),
                                    out_dtype=torch.float32)
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n", [768, 1536])
def test_k10_plain_matches_jax(n):
    """BN = 768: one scale column at N = 768, two at 1536."""
    xq, rs, wq, cs = _operands(M, K, n, 10)
    bias = _rand((n,), 14, 0.5)
    want_q, want_s = quant_jax.int8_gemm_postscale_qout_pallas(
        jnp.asarray(xq), jnp.asarray(rs), jnp.asarray(wq), jnp.asarray(cs),
        bias=jnp.asarray(bias), act="gelu_tanh", has_bias=True,
        interpret=True)
    got_q, got_s = quant.int8_gemm_postscale_qout(
        _t(xq), _t(rs), _t(wq.T), _t(cs), _t(bias), act="gelu_tanh")
    assert quant.pick_bn_div(n) == 768
    assert got_s.shape == want_s.shape == (M, n // 768)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    _int8_close(got_q.numpy(), want_q)


@pytest.mark.parametrize("gate_residual", [False, True])
def test_k11_plain_matches_jax(gate_residual):
    """bk = BN = 768 over K = 1536: two slabs, rescaled in order."""
    k, bk = 1536, 768
    xq = _int8((M, k), 15)
    xs = np.abs(_rand((M, k // bk), 16, 0.01)) + 1e-3
    wq = _int8((k, N), 17)
    cs = np.abs(_rand((N,), 18, 0.01)) + 1e-3
    bias = _rand((N,), 19, 0.5)
    gate = _rand((N,), 20) if gate_residual else None
    res = _rand((M, N), 21) if gate_residual else None
    want = quant_jax.int8_gemm_blockact_pallas(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(cs),
        bias=jnp.asarray(bias), has_bias=True, bk=bk, out_dtype=jnp.float32,
        interpret=True, gate=None if gate is None else jnp.asarray(gate),
        residual=None if res is None else jnp.asarray(res))
    got = quant.int8_gemm_blockact(
        _t(xq), _t(xs), _t(wq.T), _t(cs), _t(bias), bk=bk,
        gate=None if gate is None else _t(gate),
        residual=None if res is None else _t(res), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------

def _int8_linear(k, n, seed):
    lin = torch.nn.Linear(k, n).bfloat16()
    with torch.no_grad():
        lin.weight.copy_(_t(_rand((n, k), seed, 0.05)))
        lin.bias.copy_(_t(_rand((n,), seed + 1, 0.1)))
    return quant.Int8Linear.from_linear(lin)


def test_int8_linear_prequant_equals_the_postscale_linear():
    """int8_linear_prequant over K8's output is int8_linear_postscale."""
    lin = _int8_linear(K, N, 22)
    x = _t(_rand((2, 50, K), 23)).bfloat16()
    res = _t(_rand((2, 50, N), 24)).bfloat16()
    xq, rs = quant.quantize_rows_int8(x.reshape(-1, K))
    a = quant.int8_linear_prequant(xq.reshape(2, 50, K), rs.reshape(2, 50, 1),
                                   lin, act="gelu_tanh", residual=res)
    b = lin(x, act="gelu_tanh", residual=res)
    assert a.shape == (2, 50, N) and torch.equal(a, b)


def test_linear_maybe_quant_gate_forms():
    """A batch-1 gate rides K9's epilogue in fp32; a batch-2 gate is applied
    after the GEMM in the output dtype, as `finish` does
    (quant.py:947-954). Both equal their spelled-out forms."""
    lin = _int8_linear(K, N, 25)
    x = _t(_rand((2, 40, K), 26)).bfloat16()
    res = _t(_rand((2, 40, N), 27)).bfloat16()
    gate = _t(_rand((2, 1, N), 28))
    y = lin(x)
    got = quant.linear_maybe_quant(lin, x, gate=gate, residual=res)
    assert torch.equal(got, res + y * gate.to(y.dtype))
    got1 = quant.linear_maybe_quant(lin, x[:1], gate=gate[:1],
                                    residual=res[:1])
    assert torch.equal(got1, lin(x[:1], gate=gate[0, 0], residual=res[:1]))


def test_fused_qkv_is_the_three_linears():
    """fuse_linear_params concatenates the quantised q, k, v exactly: the
    fused output's column groups are the three outputs."""
    parts = [_int8_linear(K, 128, s) for s in (29, 31, 33)]
    fused = quant.fuse_linear_params(parts)
    x = _t(_rand((1, 30, K), 35)).bfloat16()
    y = fused(x)
    for i, p in enumerate(parts):
        assert torch.equal(y[..., i * 128:(i + 1) * 128], p(x))


def _jax_params(cfg_j, seed=0):
    from turbodiffusion_tpu.models.wan import init_wan_params as init_jax
    params = jax.tree.map(np.array, jax.jit(init_jax, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg_j))
    r = np.random.RandomState(1)
    head = params["head"]["head"]
    head["w"] = (0.05 * r.randn(*head["w"].shape)).astype(np.float32)
    return params


def _quantized_tree(params):
    q = dict(params)
    q["blocks"] = jax.tree.map(np.array, quant_jax.quantize_wan_blocks(
        jax.tree.map(jnp.asarray, params["blocks"]), mode="postscale",
        fuse_qkv=True))
    return q


def test_quantize_wan_blocks_matches_jax():
    """The same float tree quantised by both packages: bitwise equal int8
    and scales for every block linear, the fused qkv present, proj_l left
    as it was; the JAX-quantised tree loads into the port's quantised
    blocks (buffers included) with the same values."""
    attn = dict(backend="sla", block_q=8, block_k=8)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn),
                                dtype=jnp.bfloat16)
    cfg_t = wan_test_config(attention=AttentionConfig(**attn),
                            dtype=torch.bfloat16)
    params = _jax_params(cfg_j)
    qtree = _quantized_tree(params)
    model = load_jax_params(WanModel(cfg_t), params)
    proj_before = model.blocks[1].self_attn.proj_l.weight.clone()
    quant.quantize_wan_blocks(model.blocks, mode="postscale", fuse_qkv=True)
    loaded = load_jax_params(quant.quantize_wan_blocks(
        WanModel(cfg_t).blocks), qtree["blocks"])
    blocks = qtree["blocks"]
    for i, blk in enumerate(model.blocks):
        sa = blk.self_attn
        assert sa.q is None and sa.k is None and sa.v is None
        assert isinstance(sa.proj_l, torch.nn.Linear)
        for path, lin in [(("self_attn", "qkv"), sa.qkv),
                          (("self_attn", "o"), sa.o),
                          (("cross_attn", "q"), blk.cross_attn.q),
                          (("cross_attn", "k"), blk.cross_attn.k),
                          (("cross_attn", "v"), blk.cross_attn.v),
                          (("cross_attn", "o"), blk.cross_attn.o),
                          (("ffn", "fc1"), blk.ffn.fc1),
                          (("ffn", "fc2"), blk.ffn.fc2)]:
            leaf = blocks[path[0]][path[1]]
            assert isinstance(lin, quant.Int8Linear), path
            np.testing.assert_array_equal(lin.w_int8.numpy(),
                                          leaf["w_int8"][i].T)
            np.testing.assert_array_equal(lin.scale.numpy(), leaf["scale"][i])
        other = dict(loaded[i].named_buffers())
        for name, buf in blk.named_buffers():
            assert torch.equal(other[name], buf), name
    assert torch.equal(model.blocks[1].self_attn.proj_l.weight, proj_before)
    assert "qkv" in blocks["self_attn"] and "proj_l" in blocks["self_attn"]


def test_block_layout_is_refused():
    """The 128x128 block layout (K22, Int8BlockLinear) is refused where the
    postscale layout is meant: by the int8 feeds' consumer and by QKV
    fusion (tests/test_torch_checkpoint.py holds the layout itself against
    JAX)."""
    lin = quant.quantize_linear_params(torch.nn.Linear(128, 128), mode="block")
    assert isinstance(lin, quant.Int8BlockLinear)
    with pytest.raises(ValueError, match="postscale linears"):
        quant.int8_linear_prequant(torch.zeros(2, 128, dtype=torch.int8),
                                   torch.ones(2, 1), lin)
    with pytest.raises(ValueError, match="fuses only postscale"):
        quant.fuse_linear_params([lin, lin, lin])


def test_cuda_wrappers_refuse_non_cuda_devices():
    """A tensor on neither the CPU nor a card (meta) raises; no plain
    fallback off the CPU."""
    i8 = torch.zeros(64, 128, dtype=torch.int8, device="meta")
    s = torch.zeros(64, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        quant.quantize_rows_int8(torch.zeros(64, 128, device="meta"))
    for fn in (quant.int8_gemm_postscale, quant.int8_gemm_postscale_qout,
               quant.int8_gemm_blockact):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(i8, s, i8, s)


@pytest.mark.parametrize("case", ["k10_k", "k11_k", "k11_slab"])
def test_ffn_launchers_refuse_shapes_off_their_tiles(case):
    """K10 / K11 read 128-byte TMA tiles of K: the launchers refuse K, or
    K11's slab, that is a multiple of K9's 64 but not of 128, before any
    build or launch (CPU tensors reach the check, then nothing else)."""
    K = 384 if case == "k11_slab" else 192
    xq, wq = torch.zeros(8, K, dtype=torch.int8), torch.zeros(768, K, dtype=torch.int8)
    rs, cs = torch.ones(8, 1), torch.ones(768)
    if case == "k10_k":
        fn, call = quant._int8_gemm_qout_cuda, lambda: quant._int8_gemm_qout_cuda(
            xq, rs, wq, cs, None, None)
    else:
        bk = 192 if case == "k11_slab" else K
        fn = quant._int8_gemm_blockact_cuda
        call = lambda: fn(xq, torch.ones(8, K // bk), wq, cs, None,  # noqa: E731
                          None, bk, None, None)
    before = fn.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        call()
    assert fn.launches == before


def _off_by_one(*shape):
    """A contiguous int8 tensor one byte past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=torch.int8)[1:1 + n].view(*shape)


@pytest.mark.parametrize("case", ["k9_n", "k9_k", "k9_align", "k9_residual",
                                  "k7_block_q", "k7_block_k", "k7_align"])
def test_k9_k7_launchers_refuse_shapes_off_their_tiles(case):
    """K9 (TMA tiles of 128 columns and 128-byte K rows, K a multiple of 64)
    and K7 (128 query rows a block, 128-key chunks, TMA panels) refuse N off
    128, K off 64, an operand or residual off 16-byte alignment, and a Q or
    K block of 64 rows, before any build or launch (CPU tensors reach the
    checks, then nothing else)."""
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    if case.startswith("k9"):
        N = 200 if case == "k9_n" else 256
        K = 96 if case == "k9_k" else 128
        xq = _off_by_one(8, K) if case == "k9_align" else torch.zeros(8, K, dtype=torch.int8)
        res = (torch.zeros(8 * N + 8, dtype=torch.bfloat16)[1:1 + 8 * N].view(8, N)
               if case == "k9_residual" else None)
        fn = quant._int8_gemm_postscale_cuda
        call = lambda: fn(xq, torch.ones(8, 1), torch.zeros(N, K, dtype=torch.int8),  # noqa: E731
                          torch.ones(N), None, None, None, res)
        match = "multiple of" if case in ("k9_n", "k9_k") else "16-byte aligned"
    else:
        bq, bk = (64, 128) if case == "k7_block_q" else (128, 64) if case == "k7_block_k" \
            else (128, 128)
        Lp, H, D = 256, 1, 128
        qi = (_off_by_one(1, H, Lp, D) if case == "k7_align"
              else torch.zeros(1, H, Lp, D, dtype=torch.int8))
        nK = Lp // bk
        fn = si8._sparse_i8_vt_cuda
        call = lambda: fn(qi, torch.ones(1, H, Lp), torch.zeros(1, H, Lp, D, dtype=torch.int8),  # noqa: E731
                          torch.zeros(1, H, nK, D, bk, dtype=torch.int8),
                          torch.ones(1, H, nK), torch.ones(1, H, 1, D),
                          torch.zeros(1, H, Lp // bq, 1, dtype=torch.int32),
                          D ** -0.5, bq, bk, Lp, None, None)
        match = "multiple of 128" if case != "k7_align" else "16-byte aligned"
    before = fn.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("case", ["k4_head_dim_64", "k4_stride", "k4_align", "k4_kv_len",
                                  "k22_dtype", "k22_align"])
def test_k4_k22_launchers_refuse_what_the_kernels_do_not_take(case):
    """K4 (TMA boxes of 64 bf16 channels over (B, L, H, 128) read through
    16-byte strides) and K22 (TMA tiles of 128-byte int8 rows) refuse head
    dim 64, a head stride or a base off 16 bytes, kv_len past the keys and
    a non-int8 operand, before any build or launch (CPU tensors reach the
    checks, then nothing else)."""
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    if case.startswith("k4"):
        D = 64 if case == "k4_head_dim_64" else 128
        q = kv = torch.zeros(1, 64, 2, D, dtype=torch.bfloat16)
        if case == "k4_stride":          # heads 132 channels apart
            q = torch.zeros(1, 64, 2, 132, dtype=torch.bfloat16)[..., :128]
        elif case == "k4_align":
            q = torch.zeros(64 * 2 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 2, 128)
        kv_len = 65 if case == "k4_kv_len" else 64
        fn = fa._flash_cuda
        call = lambda: fn(q, kv, kv, 0.1, kv_len)                # noqa: E731
        match = {"k4_head_dim_64": "head dim 128", "k4_kv_len": "out of range"}.get(
            case, "16-byte aligned")
    else:
        xq, wq = torch.zeros(8, 128, dtype=torch.int8), torch.zeros(256, 128, dtype=torch.int8)
        if case == "k22_dtype":
            xq = xq.to(torch.bfloat16)
        else:
            xq = _off_by_one(8, 128)
        fn = quant._int8_block_matmul_cuda
        call = lambda: fn(xq, torch.ones(1, 1), wq, torch.ones(2, 1), None,  # noqa: E731
                          torch.float32)
        match = "int8" if case == "k22_dtype" else "16-byte aligned"
    before = fn.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert fn.launches == before


def test_row_stride_reads_column_groups_in_place():
    """K2 and K5 read Q/K/V as column groups of the fused QKV output: rows
    3*D apart; a tensor whose last stride is not 1 is refused."""
    qkv = torch.zeros(2, 10, 3 * 256)
    q, k, v = qkv.split(256, -1)
    assert _row_stride(k, "K5") == 768 and _row_stride(v, "K5") == 768
    with pytest.raises(ValueError, match="unit last stride"):
        _row_stride(qkv.transpose(1, 2), "K5")


# ---------------------------------------------------------------------------
# the slice: a tiny W8A8 DiT and one FFN
# ---------------------------------------------------------------------------

SIZE = dict(dim=256, ffn_dim=1536, num_heads=2)     # 2 x 128, BN 768


def _patch_fused_jax(monkeypatch):
    """JAX's fused SageSLA branch and int8 O feed on the CPU: the branch
    forced on and its Pallas kernels in interpret mode (test-only)."""
    import turbodiffusion_tpu.models.wan as wan_jax
    import turbodiffusion_tpu.ops.attention as attention_jax
    import turbodiffusion_tpu.ops.sla_fused as sla_fused_jax
    monkeypatch.setattr(wan_jax, "_use_fused_sla", lambda p, cfg: True)
    for mod, name in ((attention_jax, "sla_attention_fused"),
                      (sla_fused_jax, "unfold_quant"),
                      (quant_jax, "int8_gemm_postscale_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


@pytest.mark.parametrize("backend", ["sagesla", "sla"])
def test_wan_forward_w8a8_matches_jax(monkeypatch, backend):
    """WanModel.forward with W8A8 linears (dim 256, 2 heads x 128, ffn 1536,
    2 layers, blocks 128, 520 tokens, bf16) loaded from a JAX tree quantised
    by quantize_wan_blocks, against JAX `wan_forward` on the same tree; the
    unquantised forward of the float tree is the reference of both."""
    import turbodiffusion_tpu.models.wan as wan_jax
    if backend == "sagesla":
        _patch_fused_jax(monkeypatch)
    attn = dict(backend=backend, sla_topk=0.5, block_q=128, block_k=128,
                linear_branch=False)
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**attn),
                                dtype=jnp.bfloat16, **SIZE)
    cfg_t = wan_test_config(attention=AttentionConfig(**attn),
                            dtype=torch.bfloat16, quant_linear=True, **SIZE)
    params = _jax_params(cfg_j)
    qtree = _quantized_tree(params)
    model = WanModel(cfg_t)
    quant.quantize_wan_blocks(model.blocks)
    load_jax_params(model, qtree)

    x = _rand((1, 16, 5, 16, 26), 2)              # 5 x 8 x 13 = 520 tokens
    t = np.full((1, 1), 537.0, np.float32)
    ctx = _rand((1, 16, 32), 3)

    def jax_fwd(tree):
        return np.asarray(wan_jax.wan_forward(
            jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(x),
            jnp.asarray(t), jnp.asarray(ctx)), np.float32)

    ref, want = jax_fwd(params), jax_fwd(qtree)
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(ctx)).float().numpy()
    assert got.shape == want.shape == x.shape
    scale = np.abs(ref).max()
    err_jax = np.abs(want - ref).mean()
    err_port = np.abs(got - ref).mean()
    assert scale > 0.1 and err_jax > 1e-4          # live, and int8 is felt
    assert err_port <= 1.2 * err_jax + 1e-4, (err_port, err_jax)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)


def test_w8a8_ffn_matches_the_jax_kernel_chain():
    """WanFFN at batch 1 (K8 -> K10 -> K11, gate + residual) against the JAX
    interpret-mode kernels composed the same way (wan.py:248-268)."""
    from turbodiffusion_tpu_torch.models.wan import WanFFN
    D, F_ = SIZE["dim"], SIZE["ffn_dim"]
    cfg_t = wan_test_config(dtype=torch.bfloat16, **SIZE)
    ffn = WanFFN(cfg_t)
    with torch.no_grad():
        ffn.fc1.weight.copy_(_t(_rand((F_, D), 40, 0.05)))
        ffn.fc1.bias.copy_(_t(_rand((F_,), 41, 0.1)))
        ffn.fc2.weight.copy_(_t(_rand((D, F_), 42, 0.03)))
        ffn.fc2.bias.copy_(_t(_rand((D,), 43, 0.1)))
    ffn.fc1 = quant.Int8Linear.from_linear(ffn.fc1)
    ffn.fc2 = quant.Int8Linear.from_linear(ffn.fc2)
    L = 300
    x = _t(_rand((1, L, D), 44)).bfloat16()
    res = _t(_rand((1, L, D), 45)).bfloat16()
    gate = _t(_rand((1, 1, D), 46))
    with torch.no_grad():
        got = ffn(x, gate=gate, residual=res).float().numpy()

    def j(a):
        a = a.detach()
        return jnp.asarray(a.numpy() if a.dtype == torch.int8
                           else a.float().numpy())

    bn = quant_jax._pick_bn_div(F_)
    xq, rs = quant_jax.quantize_rows_int8_pallas(
        jnp.asarray(x[0].float().numpy(), jnp.bfloat16), interpret=True)
    hq, hs = quant_jax.int8_gemm_postscale_qout_pallas(
        xq, rs, j(ffn.fc1.w_int8).T, j(ffn.fc1.scale),
        bias=j(ffn.fc1.bias), act="gelu_tanh", has_bias=True, interpret=True)
    want = quant_jax.int8_gemm_blockact_pallas(
        hq, hs, j(ffn.fc2.w_int8).T, j(ffn.fc2.scale), bias=j(ffn.fc2.bias),
        has_bias=True, bk=bn, interpret=True, gate=j(gate).reshape(-1),
        residual=jnp.asarray(res[0].float().numpy(), jnp.bfloat16))
    want = np.asarray(want, np.float32)[None]
    assert got.shape == want.shape == (1, L, D)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
