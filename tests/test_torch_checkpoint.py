"""Checkpoint import of the PyTorch port against the JAX package, and K22.

Every checkpoint here is written by the test itself, in the reference's
naming and layout: the DiT by JAX's own writer (`wan_state_dict_from_params`
over seeded JAX parameters, saved by JAX's `convert._save_state_dict`: fp32
to bf16 except scales), the VAE and umT5 by a test-side inverse of JAX's
import mapping (JAX has no writer for them). Both packages' loaders read the
same file. Inputs are numpy-seeded; the tiny `test` model runs in fp32.

Tolerances, with reasons:
  * K22's plain version against `_int8_block_matmul_pallas` in interpret
    mode: the same fp32 terms in the same K-block order, which XLA may
    contract into fused multiply-adds: 2^-20 of the largest output (a few
    fp32 ulps); against `int8_block_matmul_ref` (the terms summed at the
    end, in another order): 1e-6 of the largest output;
  * the block quantisers, the RoPE permutations and every loaded parameter:
    bit-equal (the same IEEE division and round-half-even in both);
  * DiT forwards from one block-quantised checkpoint: atol 1e-4 on
    velocities of order 1 (fp32 sums in another order; the int8 operands
    are bit-equal), well inside the 2e-3 bound;
  * the parity replay: every stage at or above the script's 30 dB.
"""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.config import wan_test_config as wan_test_config_jax
from turbodiffusion_tpu.models import rope as rope_jax
from turbodiffusion_tpu.models.umt5 import init_umt5_params as init_umt5_jax
from turbodiffusion_tpu.models.umt5 import umt5_test_config as umt5_cfg_jax
from turbodiffusion_tpu.models.vae import VAEConfig as VAEConfigJax
from turbodiffusion_tpu.models.vae import init_vae_params as init_vae_jax
from turbodiffusion_tpu.models.wan import init_wan_params as init_wan_jax
from turbodiffusion_tpu.models.wan import wan_forward
from turbodiffusion_tpu.ops import quant as quant_jax
from turbodiffusion_tpu.pipelines import pipeline as pipeline_jax
from turbodiffusion_tpu.scripts.convert import _save_state_dict as save_jax
from turbodiffusion_tpu.utils import checkpoint as ckpt_jax
from turbodiffusion_tpu_torch.config import AttentionConfig, wan_test_config
from turbodiffusion_tpu_torch.models import rope
from turbodiffusion_tpu_torch.models.umt5 import UMT5Encoder, umt5_test_config
from turbodiffusion_tpu_torch.models.vae import VAEConfig, WanVAE
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.ops import quant
from turbodiffusion_tpu_torch.pipelines import pipeline
from turbodiffusion_tpu_torch.utils import checkpoint as ckpt
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

ATTN = dict(backend="sla", sla_topk=0.5, block_q=8, block_k=8)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K22 and the block quantisers
# ---------------------------------------------------------------------------

def _block_operands(M, K, N, seed):
    """int8 operands with block scales that span a factor of ~50, so that a
    scale read from the wrong block shows; the weight as JAX stores it (K,
    N) with scale (Kb, Nb)."""
    r = np.random.RandomState(seed)
    xq = r.randint(-127, 128, (M, K)).astype(np.int8)
    wq = r.randint(-127, 128, (K, N)).astype(np.int8)
    cd = lambda n: -(-n // 128)                     # noqa: E731
    xs = (1e-3 * np.exp(r.uniform(0, 4, (cd(M), cd(K))))).astype(np.float32)
    ws = (1e-3 * np.exp(r.uniform(0, 4, (cd(K), cd(N))))).astype(np.float32)
    return xq, xs, wq, ws


@pytest.mark.parametrize("with_bias", [False, True])
def test_k22_plain_matches_the_jax_kernel(with_bias):
    """Ragged M, K and N (none a multiple of 128)."""
    M, K, N = 150, 200, 140
    xq, xs, wq, ws = _block_operands(M, K, N, 0)
    b = np.random.RandomState(1).randn(N).astype(np.float32)
    got = quant.int8_block_matmul_plain(
        _t(xq), _t(xs), _t(wq.T), _t(ws.T), _t(b) if with_bias else None).numpy()
    pal = np.asarray(quant_jax._int8_block_matmul_pallas(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws),
        jnp.asarray(b) if with_bias else None, has_bias=with_bias,
        interpret=True))
    ref = np.asarray(quant_jax.int8_block_matmul_ref(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws)))
    ref = ref + b if with_bias else ref
    assert got.shape == pal.shape == (M, N) and got.dtype == np.float32
    peak = float(np.abs(pal).max())
    np.testing.assert_allclose(got, pal, rtol=0, atol=2.0 ** -20 * peak)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * peak)
    # the dispatching wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(quant.int8_block_matmul(
        _t(xq), _t(xs), _t(wq.T), _t(ws.T), _t(b) if with_bias else None
    ).numpy(), got)


@pytest.mark.parametrize("what", ["weight", "activation"])
def test_block_quantisers_match_jax_bitwise(what):
    """quantize_int8_block on the (out, in) weight is JAX's on (in, out),
    transposed; quantize_activation_block's int8 and scales equal JAX's on
    the (M, K) values (JAX's zero padding past M and K sliced off, as its
    int8_linear_block slices it). Values span five orders of magnitude
    across blocks."""
    r = np.random.RandomState(2)
    a = (r.randn(300, 200) * np.exp(3 * r.randn(300, 200))).astype(np.float32)
    if what == "weight":
        qj, sj = quant_jax.quantize_int8_block(jnp.asarray(a))
        q, s = quant.quantize_int8_block(_t(a.T))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj).T)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj).T)
    else:
        qj, sj = quant_jax.quantize_activation_block(jnp.asarray(a))
        q, s = quant.quantize_activation_block(_t(a))
        assert q.shape == (300, 200)
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[:300, :200])
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_block_layout_modules_and_dispatch():
    """quantize_linear_params(mode="block") gives an Int8BlockLinear (not an
    Int8Linear, so the model keeps it off the postscale int8 feeds), whose
    forward is int8_linear_block: the block quantiser, then K22 over the
    rows of every sample; fc1's GELU follows the GEMM, in the output
    dtype."""
    lin = torch.nn.Linear(200, 260, dtype=torch.float32)
    torch.nn.init.normal_(lin.bias)
    q = quant.quantize_linear_params(lin, mode="block")
    assert isinstance(q, quant.Int8BlockLinear) and not isinstance(
        q, quant.Int8Linear)
    assert q.w_int8.shape == (260, 200) and q.scale.shape == (3, 2)
    x = _t(np.random.RandomState(3).randn(2, 70, 200).astype(np.float32))
    xq, xs = quant.quantize_activation_block(x.reshape(140, 200))
    want = quant.int8_block_matmul_plain(xq, xs, q.w_int8, q.scale,
                                         q.bias.detach()).reshape(2, 70, 260)
    with torch.no_grad():
        assert torch.equal(quant.linear_maybe_quant(q, x), want)
        assert torch.equal(quant.linear_maybe_quant(q, x, act="gelu_tanh"),
                           torch.nn.functional.gelu(want, approximate="tanh"))


def test_block_layout_is_refused():
    """The block layout is refused where only the postscale layout is
    meant: by the int8 feeds' consumer (K9's epilogue would read its 2-D
    scale as per-channel ones) and by QKV fusion; an unknown layout is
    refused by name."""
    q = quant.quantize_linear_params(torch.nn.Linear(128, 128), mode="block")
    xq = torch.zeros(4, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="postscale linears"):
        quant.int8_linear_prequant(xq, torch.ones(4, 1), q)
    with pytest.raises(ValueError, match="fuses only postscale"):
        quant.fuse_linear_params([q, q, q])
    with pytest.raises(ValueError, match="unknown W8A8 layout"):
        quant.quantize_linear_params(torch.nn.Linear(8, 8), mode="blocks")


# ---------------------------------------------------------------------------
# the RoPE permutation
# ---------------------------------------------------------------------------

_permute_jax = jax.jit(rope_jax.permute_qk_linear, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("layout,heads,dh", [
    ("float", 2, 24), ("postscale", 2, 24),
    ("block", 2, 24),        # heads straddle 128-blocks: requantised
    ("block", 2, 128)])      # heads of whole blocks: rows permuted only
def test_permute_qk_linear_matches_jax(layout, heads, dh):
    D = heads * dh
    r = np.random.RandomState(4)
    w = (r.randn(96, D) * np.exp(r.randn(1, D))).astype(np.float32)  # (in, out)
    b = r.randn(D).astype(np.float32)
    lin = torch.nn.Linear(96, D)
    with torch.no_grad():
        lin.weight.copy_(_t(w.T))
        lin.bias.copy_(_t(b))
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    if layout != "float":
        lin = quant.quantize_linear_params(lin, mode=layout)
        p = quant_jax.quantize_linear_params(p, mode=layout)
    for inverse in (False, True):
        p = _permute_jax(p, dh, heads, inverse)
        rope.permute_qk_linear(lin, dh, heads, inverse=inverse)
        if layout == "float":
            np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                          np.asarray(p["w"]).T)
        else:
            np.testing.assert_array_equal(lin.w_int8.numpy(),
                                          np.asarray(p["w_int8"]).T)
            s = np.asarray(p["scale"])
            np.testing.assert_array_equal(lin.scale.numpy(),
                                          s.T if layout == "block" else s)
        np.testing.assert_array_equal(lin.bias.detach().numpy(), np.asarray(p["b"]))
    np.testing.assert_array_equal(rope.rope_channel_permutation(dh, heads).numpy(),
                                  np.asarray(rope_jax.rope_channel_permutation(dh, heads)))


# ---------------------------------------------------------------------------
# the DiT
# ---------------------------------------------------------------------------

def _seeded(shapes, seed):
    """Seeded numpy values for a JAX parameter structure (from
    jax.eval_shape, no compile): linear weights N(0, 1/fan_in), norm
    scales and gammas 1 + 0.1 N, everything else 0.1 N."""
    r = np.random.RandomState(seed)

    def fill(path, s):
        a = r.randn(*s.shape).astype(np.float32)
        name = path[-1].key if hasattr(path[-1], "key") else ""
        if name == "w" and len(s.shape) >= 2:
            fan_in = s.shape[-2] if len(s.shape) <= 3 else np.prod(s.shape[1:])
            return (a / np.sqrt(fan_in)).astype(np.float32)
        return (1.0 + 0.1 * a if name in ("scale", "gamma") else 0.1 * a
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _jax_sla_params():
    """Seeded parameters of JAX's `wan_test_config` sla model (fp32), in the
    structure of its init: the head and proj_l non-zero (the linear branch
    on)."""
    cfg = wan_test_config_jax(attention=AttentionConfigJax(**ATTN))
    shapes = jax.eval_shape(functools.partial(init_wan_jax, cfg=cfg),
                            jax.random.PRNGKey(0))
    return cfg, _seeded(shapes, 5)


def _write_jax_checkpoint(path, mode):
    """The sla params quantised by JAX (`quantize_wan_blocks(mode,
    fuse_qkv=False)`, the on-disk layout), written by JAX's writer and
    saved with convert's dtype rules."""
    cfg, params = _jax_sla_params()
    params = dict(params)
    params["blocks"] = quant_jax.quantize_wan_blocks(
        jax.tree.map(jnp.asarray, params["blocks"]), mode=mode, fuse_qkv=False)
    save_jax(ckpt_jax.wan_state_dict_from_params(params, cfg), str(path))
    return params


@pytest.fixture(scope="module")
def block_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "dit_block.pth"
    _write_jax_checkpoint(path, "block")
    return str(path)


@pytest.fixture(scope="module")
def jax_block_model(block_ckpt):
    """JAX's load_dit of the block checkpoint: (params, cfg)."""
    cfg = wan_test_config_jax(attention=AttentionConfigJax(**ATTN))
    return pipeline_jax.load_dit(block_ckpt, cfg)


_RECORDING = []     # the list a traced forward records into, if any


def _record(a, q, sc):
    if _RECORDING:
        _RECORDING[-1].append((np.asarray(a),
                               np.asarray(q)[:a.shape[0], :a.shape[1]],
                               np.asarray(sc)))


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's forward, jitted (one compile per input shape, shared by the
    tests), with every block-quantised activation of a recording run (its
    input, int8 values and scales) appended to `_RECORDING[-1]` in call
    order."""
    orig = quant_jax.quantize_activation_block

    def quantize(a, block=128):
        q, sc = orig(a, block)
        jax.debug.callback(_record, a, q, sc, ordered=True)
        return q, sc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant_jax, "quantize_activation_block", quantize)
        yield jax.jit(wan_forward, static_argnums=1)


def _inputs(batch):
    """(batch, 16, 2, 8, 8) latents: 32 tokens, the shape of a parity dump
    at 5 frames, "tiny" 1:1."""
    r = np.random.RandomState(6)
    x = r.randn(batch, 16, 2, 8, 8).astype(np.float32)
    t = np.full((batch, 1), 537.0, np.float32)
    ctx = r.randn(batch, 16, 32).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("batch", [1, 2])
def test_block_checkpoint_forward_matches_jax(block_ckpt, jax_block_model,
                                              jax_forward, batch, monkeypatch):
    """One block-quantised sla checkpoint (non-zero proj_l) read by both
    loaders: every block linear an Int8BlockLinear, the linear branch on,
    the same forward. At batch 2 the activation's 128-row quant blocks span
    both samples, in both packages.

    The port quantises every block linear's input as JAX does: the same
    inputs within 1e-5, scales within rtol 1e-6, int8 values equal but
    where an fp32 value computed in another order lands on the other side
    of a rounding boundary (at most one step, on at most 0.5% of the
    values). Such a step moves the velocity locally by up to ~1e-2, so the
    forwards are compared with the port fed JAX's int8 activations: then
    within atol 1e-4 (fp32 sums in another order)."""
    params_j, cfg_j = jax_block_model
    model, cfg_t = pipeline.load_dit(
        block_ckpt, wan_test_config(attention=AttentionConfig(**ATTN)),
        device="cpu")
    assert cfg_j.attention.linear_branch and cfg_t.attention.linear_branch
    for blk in model.blocks:
        lins = [getattr(blk.self_attn, c) for c in "qkvo"] + [
            getattr(blk.cross_attn, c) for c in "qkvo"] + [blk.ffn.fc1, blk.ffn.fc2]
        assert all(isinstance(m, quant.Int8BlockLinear) for m in lins)
        assert blk.self_attn.qkv is None and blk.self_attn.proj_l.weight.any()
    x, t, ctx = _inputs(batch)
    calls = []
    _RECORDING.append(calls)
    try:
        want = np.asarray(jax_forward(params_j, cfg_j, x, t, ctx))
        jax.effects_barrier()
    finally:
        _RECORDING.pop()
    seen, steps = [], [0, 0]
    orig = quant.quantize_activation_block

    def quantize(a, block=128):
        a_j, q_j, s_j = calls[len(seen)]
        q, sc = orig(a, block)
        K = a.shape[1]
        np.testing.assert_allclose(a.numpy(), a_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sc.numpy(), s_j, rtol=1e-6, atol=0)
        d = np.abs(q[:, :K].numpy().astype(np.int32) - q_j)
        assert d.max() <= 1
        steps[0] += int((d > 0).sum())
        steps[1] += d.size
        seen.append(1)
        q = q.clone()
        q[:, :K] = _t(q_j)
        return q, _t(s_j)

    monkeypatch.setattr(quant, "quantize_activation_block", quantize)
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(ctx)).numpy()
    assert len(seen) == len(calls) == 10 * cfg_t.num_layers
    assert steps[0] <= 0.005 * steps[1], steps
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loaded_parameters_equal_jax_loaders(block_ckpt):
    """Every parameter and buffer the port loads equals JAX's loaded tree
    (carried into a block-quantised port model by jax_params): int8
    weights, transposed block scales, permuted norms, proj_l, the Conv3d
    patch embedding's flattening."""
    cfg_j = wan_test_config_jax(attention=AttentionConfigJax(**ATTN))
    sd_j = ckpt_jax.strip_prefix(ckpt_jax.load_torch_state_dict(block_ckpt))
    tree = _np_tree(ckpt_jax.wan_params_from_state_dict(sd_j, cfg_j))
    cfg_t = wan_test_config(attention=AttentionConfig(**ATTN))
    ref = WanModel(cfg_t)
    quant.quantize_wan_blocks(ref.blocks, mode="block", fuse_qkv=False)
    load_jax_params(ref, tree)
    sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(block_ckpt))
    got = ckpt.wan_params_from_state_dict(sd, cfg_t, device="cpu")
    want = ref.state_dict()
    assert sorted(got.state_dict()) == sorted(want)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_postscale_checkpoint_fuses_qkv_at_load(tmp_path):
    """A postscale checkpoint (JAX-written) under --quant_linear: Q / K / V
    fused into one Int8Linear at load below dim 4096 (JAX's rule,
    pipeline.py:87-93), equal to JAX's `fuse_linear_params` of the leaves
    it wrote (postscale Q / K permute exactly, with their scales); without
    --quant_linear left separate. JAX's own load_dit tests
    the stacked scale's ndim (2, not 1) and so never fuses a loaded
    postscale checkpoint; the port follows the rule as written (fused or
    not, the product is the same: one row quantisation of one input)."""
    path = tmp_path / "dit_postscale.pth"
    sa_j = _write_jax_checkpoint(path, "postscale")["blocks"]["self_attn"]
    qkv = quant_jax.fuse_linear_params([sa_j["q"], sa_j["k"], sa_j["v"]])
    attn_t = AttentionConfig(**ATTN)
    model, _ = pipeline.load_dit(
        str(path), wan_test_config(attention=attn_t, quant_linear=True),
        device="cpu")
    for i, blk in enumerate(model.blocks):
        sa = blk.self_attn
        assert sa.q is None and isinstance(sa.qkv, quant.Int8Linear)
        np.testing.assert_array_equal(sa.qkv.w_int8.numpy(),
                                      np.asarray(qkv["w_int8"][i]).T)
        np.testing.assert_array_equal(sa.qkv.scale.numpy(),
                                      np.asarray(qkv["scale"][i]))
    plain, _ = pipeline.load_dit(
        str(path), wan_test_config(attention=attn_t), device="cpu")
    assert plain.blocks[0].self_attn.qkv is None
    assert isinstance(plain.blocks[0].self_attn.q, quant.Int8Linear)


def test_writer_round_trips_and_refuses_i2v(block_ckpt, tmp_path):
    """The port's writer is the inverse of its loader (a float checkpoint:
    exact), its block export equals JAX's on the same parameters, and I2V
    keys are refused naming their ROADMAP item."""
    cfg_t = wan_test_config(attention=AttentionConfig(**ATTN))
    sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(block_ckpt))
    model = ckpt.wan_params_from_state_dict(sd, cfg_t, device="cpu")
    out = ckpt.wan_state_dict_from_params(model, cfg_t)
    assert sorted(out) == sorted(sd)
    for k in out:       # the file's own values, up to its bf16 rounding
        if "self_attn.q." not in k and "self_attn.k." not in k:
            assert torch.equal(out[k].to(sd[k].dtype), sd[k]), k
    float_model = WanModel(cfg_t)
    again = ckpt.wan_params_from_state_dict(
        ckpt.wan_state_dict_from_params(float_model, cfg_t), cfg_t, "cpu")
    for (k, a), b in zip(float_model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    sd_i2v = dict(sd, **{"blocks.0.cross_attn.k_img.weight": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        ckpt.wan_params_from_state_dict(sd_i2v, cfg_t, "cpu")


def test_convert_quantize_block_matches_jax(tmp_path):
    """`convert quantize --mode block` of a float checkpoint gives JAX's
    convert output, key by key and bit by bit."""
    cfg, params = _jax_sla_params()
    src = tmp_path / "float.pth"
    save_jax(ckpt_jax.wan_state_dict_from_params(params, cfg), str(src))
    from turbodiffusion_tpu.scripts import convert as convert_jax
    from turbodiffusion_tpu_torch.scripts import convert
    args = dict(model="test", input_path=str(src), attention_type="sla",
                sla_topk=0.5, quant_linear=True, mode="block")
    convert_jax.cmd_quantize(argparse.Namespace(
        output_path=str(tmp_path / "jax.pth"), **args))
    convert.main(["quantize", "--output_path", str(tmp_path / "port.pth"),
                  "--device", "cpu", "--model", "test", "--input_path",
                  str(src), "--attention_type", "sla", "--sla_topk", "0.5",
                  "--quant_linear", "--mode", "block"])
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_strip_prefix_and_safetensors_match_jax(tmp_path):
    cases = [{"net.a": 1, "net_ema.a": 2, "b": 3}, {"net.a": 1, "c": 2},
             {"a": 1, "b": 2}]
    for sd in cases:
        assert ckpt.strip_prefix(sd) == ckpt_jax.strip_prefix(sd)
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file
    sd = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()}
    save_file(sd, str(tmp_path / "m.safetensors"))
    got = ckpt.load_torch_state_dict(str(tmp_path / "m.safetensors"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], sd["w"])
    merged = ckpt.merge_models({"w": torch.ones(2), "n": torch.zeros(1)},
                               {"w": torch.full((2,), 3.0), "p": torch.ones(1)},
                               {"w": torch.full((2,), 2.0)}, weight=0.5)
    assert merged["w"].tolist() == [1.5, 1.5] and set(merged) == {"w", "n", "p"}


def test_check_ported_decides_from_the_loaded_layout():
    """A 14B block-scale checkpoint runs the bf16 feeds at dim 5120 (K2
    above 4096) and is refused on a card naming Queue A item 15; a 14B
    postscale checkpoint takes the W8A8 path with or without
    --quant_linear; the CPU refuses nothing."""
    for layout, ql in (("block", True), ("block", False), ("float", False)):
        with pytest.raises(NotImplementedError, match="Queue A item 15"):
            pipeline.check_ported("Wan2.1-14B", "sagesla", ql, "cuda", layout)
    for layout, ql in (("postscale", False), ("float", True)):
        pipeline.check_ported("Wan2.1-14B", "sagesla", ql, "cuda", layout)
    pipeline.check_ported("Wan2.1-14B", "sagesla", False, "cpu", "block")
    pipeline.check_ported("Wan2.1-1.3B", "sagesla", False, "cuda", "block")


# ---------------------------------------------------------------------------
# VAE, umT5, the tokenizer refusal
# ---------------------------------------------------------------------------

def _seeded_vae_tree(seed):
    """VAEConfig(dim=16, fp32)'s JAX parameter structure, encoder included,
    with seeded values."""
    return _seeded(jax.eval_shape(functools.partial(
        init_vae_jax, cfg=VAEConfigJax(dim=16, dtype=jnp.float32)),
        jax.random.PRNGKey(0)), seed)


def _vae_state_dict(tree):
    """The inverse of JAX's vae_params_from_state_dict: reference keys."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"], p["b"]

    def res(pre, p):
        sd[f"{pre}.residual.0.gamma"] = p["norm1"]["gamma"]
        conv(f"{pre}.residual.2", p["conv1"])
        sd[f"{pre}.residual.3.gamma"] = p["norm2"]["gamma"]
        conv(f"{pre}.residual.6", p["conv2"])
        if p.get("shortcut") is not None:
            conv(f"{pre}.shortcut", p["shortcut"])

    for side, seq in (("encoder", "downsamples"), ("decoder", "upsamples")):
        t = tree[side]
        conv(f"{side}.conv1", t["conv1"])
        for i, layer in enumerate(t[seq]):
            pre = f"{side}.{seq}.{i}"
            if "norm1" in layer:
                res(pre, layer)
            else:
                conv(f"{pre}.resample.1", layer["conv"])
                if "time_conv" in layer:
                    conv(f"{pre}.time_conv", layer["time_conv"])
        mid = t["middle"]
        res(f"{side}.middle.0", mid[0])
        sd[f"{side}.middle.1.norm.gamma"] = mid[1]["norm"]["gamma"]
        conv(f"{side}.middle.1.to_qkv", mid[1]["to_qkv"])
        conv(f"{side}.middle.1.proj", mid[1]["proj"])
        res(f"{side}.middle.2", mid[2])
        sd[f"{side}.head.0.gamma"] = t["head_norm"]["gamma"]
        conv(f"{side}.head.2", t["head_conv"])
    conv("conv1", tree["conv1"])
    conv("conv2", tree["conv2"])
    return {k: _t(np.asarray(v)) for k, v in sd.items()}


def _assert_same_params(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_vae_loader_matches_jax():
    cfg = VAEConfig(dim=16, dtype=torch.float32)
    sd = _vae_state_dict(_seeded_vae_tree(7))
    tree_j = _np_tree(ckpt_jax.vae_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, dtype=jnp.float32))
    want = load_jax_params(WanVAE(cfg), tree_j)
    _assert_same_params(ckpt.vae_params_from_state_dict(sd, cfg, "cpu"), want)


def _umt5_state_dict(tree, num_layers):
    sd = {"token_embedding.weight": tree["token_embedding"],
          "norm.weight": tree["norm"]["w"]}
    b = tree["blocks"]
    for i in range(num_layers):
        pre = f"blocks.{i}"
        sd[f"{pre}.norm1.weight"] = b["norm1"]["w"][i]
        sd[f"{pre}.norm2.weight"] = b["norm2"]["w"][i]
        sd[f"{pre}.pos_embedding.embedding.weight"] = b["pos_embedding"][i]
        for c in ("q", "k", "v", "o"):
            sd[f"{pre}.attn.{c}.weight"] = b["attn"][c][i].T
        sd[f"{pre}.ffn.gate.0.weight"] = b["ffn"]["gate"][i].T
        for c in ("fc1", "fc2"):
            sd[f"{pre}.ffn.{c}.weight"] = b["ffn"][c][i].T
    return {k: _t(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def umt5_ckpt(tmp_path_factory):
    tree = _seeded(jax.eval_shape(functools.partial(
        init_umt5_jax, cfg=umt5_cfg_jax()), jax.random.PRNGKey(0)), 8)
    sd = _umt5_state_dict(tree, umt5_cfg_jax().num_layers)
    path = tmp_path_factory.mktemp("umt5") / "umt5.pth"
    torch.save(sd, path)
    return str(path), sd, tree


def test_umt5_loader_matches_jax(umt5_ckpt):
    path, sd, _ = umt5_ckpt
    tree_j = _np_tree(ckpt_jax.umt5_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, umt5_cfg_jax().num_layers,
        dtype=jnp.float32))
    want = load_jax_params(UMT5Encoder(umt5_test_config()), tree_j)
    got = ckpt.umt5_params_from_state_dict(
        ckpt.load_torch_state_dict(path), umt5_test_config(), "cpu")
    _assert_same_params(got, want)


def test_hash_tokenizer_is_refused_with_real_weights(umt5_ckpt, monkeypatch):
    """Real umT5 weights and no tokenizer directory: RuntimeError, unless
    TDX_ALLOW_HASH_TOKENIZER=1; random weights take the hash fallback."""
    path = umt5_ckpt[0]
    monkeypatch.delenv("TDX_ALLOW_HASH_TOKENIZER", raising=False)
    te = pipeline.TextEncoder(path, cfg=umt5_test_config(), device="cpu")
    with pytest.raises(RuntimeError, match="refusing the hash-tokenizer"):
        te("a cat")
    monkeypatch.setenv("TDX_ALLOW_HASH_TOKENIZER", "1")
    assert te("a cat").shape == (1, 16, 32)
    monkeypatch.delenv("TDX_ALLOW_HASH_TOKENIZER")
    rand = pipeline.TextEncoder(None, cfg=umt5_test_config(), device="cpu")
    assert rand("a cat").shape == (1, 16, 32)


# ---------------------------------------------------------------------------
# the whole pipeline: a port replay of a JAX parity dump
# ---------------------------------------------------------------------------

def test_parity_replay_of_a_jax_dump(block_ckpt, jax_block_model, jax_forward,
                                     tmp_path, monkeypatch):
    """JAX `parity dump --model test --dit_path <block checkpoint>` (sla,
    ODE, 2 steps), replayed by the port's parity script on the same
    checkpoint. JAX ignores vae_path at --model test (pipeline.py:204-210),
    so its test VAE is carried into the port's pipeline by jax_params. The
    JAX pipeline is assembled as `create` assembles it for the test model,
    from JAX's load_dit of the checkpoint, with seeded VAE values and a
    seeded text embedding (an input of the replay, which reads it from the
    dump); its forward is jitted (the same function, one compile, shared
    with the forward tests)."""
    from turbodiffusion_tpu.scripts import parity as parity_jax
    from turbodiffusion_tpu_torch.scripts import parity
    params_j, cfg_j = jax_block_model
    vae_tree = _seeded_vae_tree(9)
    emb = np.random.RandomState(10).randn(1, cfg_j.text_len, cfg_j.text_dim)

    def te(prompt):             # the text embedding is an input of replay
        return jnp.asarray(emb, jnp.float32)

    monkeypatch.setattr(pipeline_jax, "wan_forward",
                        lambda p, cfg, x, t, e, y_B_C_T_H_W=None:
                        jax_forward(p, cfg, x, t, e))
    monkeypatch.setattr(parity_jax, "_build_pipeline", lambda args:
                        pipeline_jax.WanPipeline(cfg=cfg_j, params=params_j,
                                                 vae_params=vae_tree,
                                                 text_encoder=te))
    dump = str(tmp_path / "golden")
    common = dict(model="test", dit_path=block_ckpt, vae_path=None,
                  text_encoder_path=None, attention_type="sla", sla_topk=0.5,
                  quant_linear=False, random_weights=False, seed=0)
    parity_jax.cmd_dump(argparse.Namespace(
        out_dir=dump, prompt="a red boat", num_steps=2, sigma_max=80.0,
        num_frames=5, resolution="tiny", aspect_ratio="1:1", **common))
    pipe = parity.build_pipeline(argparse.Namespace(
        tokenizer_path=None, device="cpu", **common))
    load_jax_params(pipe.vae, vae_tree)
    assert pipe.cfg.attention.linear_branch
    assert isinstance(pipe.dit.blocks[0].ffn.fc1, quant.Int8BlockLinear)
    worst = parity.replay(pipe, dump)
    assert os.path.exists(os.path.join(dump, "latent_step_001.npy"))
    assert worst >= 30.0, worst


def test_port_parity_dump_replays_bit_equal(block_ckpt, tmp_path):
    """The port's own `parity dump` of the block checkpoint, replayed by its
    `replay`: the same pipeline on the same inputs, every stage equal
    (PSNR inf), through the script's command line."""
    from turbodiffusion_tpu_torch.scripts import parity
    dump = str(tmp_path / "golden")
    common = ["--model", "test", "--dit_path", block_ckpt, "--attention_type",
              "sla", "--sla_topk", "0.5", "--device", "cpu"]
    parity.main(["dump", "--out_dir", dump, "--num_steps", "2",
                 "--num_frames", "5", "--resolution", "tiny",
                 "--aspect_ratio", "1:1"] + common)
    parity.main(["replay", "--dump_dir", dump, "--min_psnr", "1000"] + common)
