"""Sampler, umT5, VAE decode, the T2V slice and the CLI of the PyTorch port
against the JAX package, at the tiny `test` sizes, in fp32.

Parameters come from the JAX package's random init (as numpy, loaded by
utils/jax_params); noise is drawn with jax.random exactly as the JAX
pipeline draws it and handed to both. Tolerances: umT5 1e-5, VAE decode
1e-4, the whole slice 2e-4 (fp32 math in another order, compounded over the
encoder, four DiT steps and the decoder; values of magnitude ~1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.config import GenerationConfig as GenerationConfigJax
from turbodiffusion_tpu.models.umt5 import init_umt5_params as init_umt5_jax
from turbodiffusion_tpu.models.umt5 import umt5_embed_padded as embed_jax
from turbodiffusion_tpu.models.umt5 import umt5_test_config as umt5_cfg_jax
from turbodiffusion_tpu.models.vae import VAEConfig as VAEConfigJax
from turbodiffusion_tpu.models.vae import init_vae_params as init_vae_jax
from turbodiffusion_tpu.models.vae import vae_decode as vae_decode_jax
from turbodiffusion_tpu.pipelines.pipeline import WanPipeline as WanPipelineJax
from turbodiffusion_tpu.pipelines.sampler import rcm_sample as rcm_sample_jax
from turbodiffusion_tpu.pipelines.sampler import rcm_timesteps as rcm_timesteps_jax
from turbodiffusion_tpu_torch.config import GenerationConfig
from turbodiffusion_tpu_torch.models.umt5 import (
    UMT5Encoder, umt5_embed_padded, umt5_test_config)
from turbodiffusion_tpu_torch.models.vae import VAEConfig, WanVAE, vae_decode
from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline
from turbodiffusion_tpu_torch.pipelines.sampler import rcm_sample, rcm_timesteps
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jit_init(fn):
    """The JAX package's random init, jitted: the same threefry draws, one
    compile instead of hundreds of eager ops."""
    return jax.jit(fn, static_argnums=1)


def _jax_test_pipeline(monkeypatch):
    """WanPipeline.create(model="test", attention_type="sla") of the JAX
    package, assembled as `create` does for the test model, with jitted
    inits, seeded VAE values, and without its unused full-size VAE init."""
    import turbodiffusion_tpu.pipelines.pipeline as pipeline_jax
    monkeypatch.setattr(pipeline_jax, "init_wan_params",
                        _jit_init(pipeline_jax.init_wan_params))
    monkeypatch.setattr(pipeline_jax, "init_umt5_params",
                        _jit_init(pipeline_jax.init_umt5_params))
    cfg = pipeline_jax.make_wan_cfg("test", "sla")
    params, cfg = pipeline_jax.load_dit(None, cfg)
    vae = jax.tree.map(jnp.asarray, _seeded_vae_tree(4))
    te = pipeline_jax.TextEncoder(None, cfg=umt5_cfg_jax(
        dim=cfg.text_dim, text_len=cfg.text_len))
    return WanPipelineJax(cfg=cfg, params=params, vae_params=vae,
                          text_encoder=te)


def _seeded_vae_tree(seed: int):
    """A VAE parameter tree with the structure of the JAX init for
    VAEConfig(dim=16, fp32) (from jax.eval_shape, no compile) and seeded
    numpy values: conv weights N(0, 1/fan_in), biases 0.1 N, gammas
    1 + 0.1 N."""
    shapes = jax.eval_shape(functools.partial(
        init_vae_jax, cfg=VAEConfigJax(dim=16, dtype=jnp.float32)),
        jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)

    def fill(path, s):
        a = r.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        if name == "w":
            return a / np.sqrt(np.prod(s.shape[1:]))
        return 1.0 + 0.1 * a if name == "gamma" else 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("sigma_max", [80.0, 200.0])
def test_rcm_timesteps_equal(num_steps, sigma_max):
    np.testing.assert_array_equal(rcm_timesteps(num_steps, sigma_max),
                                  rcm_timesteps_jax(num_steps, sigma_max))


def test_rcm_sample_ode_matches_jax():
    """The ODE update on a linear velocity field (no noise involved)."""
    x0 = np.random.RandomState(0).randn(1, 4, 2, 3, 3).astype(np.float32)
    want = rcm_sample_jax(lambda x, t, i: 0.5 * x + t, jnp.asarray(x0),
                          jax.random.PRNGKey(0), ode=True)
    got = rcm_sample(lambda x, t, i: 0.5 * x + float(t), torch.from_numpy(x0),
                     ode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_umt5_matches_jax():
    params = _numpy_tree(_jit_init(init_umt5_jax)(jax.random.PRNGKey(7),
                                                  umt5_cfg_jax()))
    enc = load_jax_params(UMT5Encoder(umt5_test_config()), params)
    r = np.random.RandomState(1)
    ids = r.randint(0, 128, (2, 16)).astype(np.int32)
    mask = np.zeros((2, 16), np.int32)
    mask[0, :11], mask[1, :5] = 1, 1
    want = embed_jax(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                     jnp.asarray(mask), umt5_cfg_jax())
    with torch.no_grad():
        got = umt5_embed_padded(enc, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("chunk", [4])
def test_vae_decode_matches_jax(chunk):
    """Chunk 4, as the pipeline decodes 81 frames; the slice test below
    decodes with chunk 1."""
    params = _seeded_vae_tree(3)
    vae = load_jax_params(WanVAE(VAEConfig(dim=16, dtype=torch.float32)), params)
    z = np.random.RandomState(2).randn(1, 16, 5, 4, 4).astype(np.float32)
    want = np.asarray(vae_decode_jax(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(z), chunk=chunk))
    got = vae_decode(vae, torch.from_numpy(z), chunk=chunk).numpy()
    assert got.shape == want.shape == (1, 3, 17, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_t2v_slice_matches_jax(monkeypatch):
    """make_wan_cfg('test', 'sla') end to end: text encode, 4 rCM steps over
    the DiT (seeded head), VAE decode."""
    pj = _jax_test_pipeline(monkeypatch)
    pt = WanPipeline.create(model="test", attention_type="sla", device="cpu")
    assert not pj.cfg.attention.linear_branch
    assert not pt.cfg.attention.linear_branch          # zero proj_l rule
    head = pj.params["head"]["head"]
    head["w"] = jnp.asarray(0.05 * np.random.RandomState(3).randn(
        *head["w"].shape), jnp.float32)
    load_jax_params(pt.dit, _numpy_tree(pj.params))
    load_jax_params(pt.vae, _numpy_tree(pj.vae_params))
    pj.text_encoder.load()
    load_jax_params(pt.text_encoder.load().encoder,
                    _numpy_tree(pj.text_encoder.params))

    prompt = "a cat surfing a wave"
    emb_t = pt.text_encoder(prompt)
    ids, mask = pt.text_encoder._hash_tokens([prompt])
    emb_j = embed_jax(pj.text_encoder.params, jnp.asarray(ids.numpy(), jnp.int32),
                      jnp.asarray(mask.numpy(), jnp.int32), pj.text_encoder.cfg)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-5)

    kw = dict(num_steps=4, num_frames=5, resolution="tiny", aspect_ratio="1:1",
              seed=0)
    # the draws of pipeline.py:279-283 and :251-253
    kn, key = jax.random.split(jax.random.PRNGKey(0))
    shape = (1, 16, 2, 8, 8)
    noise = jax.random.normal(kn, shape, jnp.float32)
    steps = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        steps.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    want = pj.generate_t2v(prompt, GenerationConfigJax(**kw), text_emb=emb_j)
    got = pt.generate_t2v(prompt, GenerationConfig(**kw), text_emb=emb_t,
                          init_noise=torch.from_numpy(np.array(noise)),
                          step_noises=steps)
    assert got.shape == want.shape == (1, 3, 5, 64, 64)
    assert float(np.std(want)) > 0.01
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_cli_runs_the_test_model_on_cpu(tmp_path):
    from turbodiffusion_tpu_torch.inference.wan2_1_t2v import main
    out = tmp_path / "o.mp4"
    main(["--model", "test", "--device", "cpu", "--random_weights",
          "--attention_type", "sla", "--prompt", "a cat", "--num_frames", "5",
          "--num_steps", "2", "--resolution", "tiny", "--aspect_ratio", "1:1",
          "--save_path", str(out)])
    assert out.exists() or (tmp_path / "o.npz").exists()


def test_cli_runs_sagesla_on_cpu(tmp_path):
    """The CLI default attention on the test model (head dim 24, blocks 8:
    the composable path, which the CPU runs as JAX does there)."""
    from turbodiffusion_tpu_torch.inference.wan2_1_t2v import main
    out = tmp_path / "o.mp4"
    main(["--model", "test", "--device", "cpu", "--random_weights",
          "--attention_type", "sagesla", "--v_quant", "channel", "--prompt",
          "a cat", "--num_frames", "5", "--num_steps", "1", "--resolution",
          "tiny", "--aspect_ratio", "1:1", "--save_path", str(out)])
    assert out.exists() or (tmp_path / "o.npz").exists()


def test_v_quant_reaches_the_config(monkeypatch):
    """--v_quant goes through the CLI, WanPipeline.create and make_wan_cfg
    into AttentionConfig.v_quant; "row" builds as JAX's make_wan_cfg does
    (its kernels, K18 and K19, are ported)."""
    import turbodiffusion_tpu.pipelines.pipeline as pipeline_jax
    from turbodiffusion_tpu_torch.inference import wan2_1_t2v
    from turbodiffusion_tpu_torch.pipelines import pipeline
    assert pipeline.make_wan_cfg("test", "sagesla").attention.v_quant == "channel"
    cfg = pipeline.make_wan_cfg("Wan2.1-1.3B", "sagesla", v_quant="channel")
    assert (cfg.attention.backend, cfg.attention.v_quant) == ("sagesla", "channel")
    for model, blk in (("test", 256), ("Wan2.1-1.3B", 64), ("Wan2.1-1.3B", 256)):
        got = pipeline.make_wan_cfg(model, "sagesla", sla_block=blk,
                                    v_quant="row").attention
        want = pipeline_jax.make_wan_cfg(model, "sagesla", sla_block=blk,
                                         v_quant="row").attention
        assert (got.backend, got.v_quant, got.block_q, got.block_k) == (
            want.backend, want.v_quant, want.block_q, want.block_k)
    pipe = pipeline.WanPipeline.create(model="test", v_quant="row",
                                       device="cpu")
    assert pipe.cfg.attention.v_quant == "row"
    seen = {}

    def create(**kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(pipeline.WanPipeline, "create", staticmethod(create))
    with pytest.raises(SystemExit):
        wan2_1_t2v.main(["--model", "test", "--device", "cpu",
                         "--random_weights", "--prompt", "x"])
    assert seen["v_quant"] == "channel"
    assert seen["attention_type"] == "sagesla"
    assert seen["quant_linear"] is False


@pytest.mark.parametrize("flag", [["--serve"], ["--mesh", "1,1,2"],
                                  ["--dit_path", "x.pth"], ["--quant_linear"],
                                  ["--v_quant", "row"]])
def test_cli_refuses_paths_not_ported(monkeypatch, flag):
    """Each flag of a path the port lacks raises naming its ROADMAP item.
    --quant_linear (the W8A8 linears, K8-K11), --v_quant row (K18, K19) and
    --dit_path (checkpoint import, K22 for block-scaled linears) are
    ported: the CLI forwards them to WanPipeline.create instead."""
    from turbodiffusion_tpu_torch.inference.wan2_1_t2v import main
    from turbodiffusion_tpu_torch.pipelines import pipeline
    base = ["--model", "test", "--device", "cpu", "--random_weights",
            "--prompt", "x", "--attention_type", "sla"]
    if flag in (["--quant_linear"], ["--v_quant", "row"],
                ["--dit_path", "x.pth"]):
        seen = {}

        def create(**kw):
            seen.update(kw)
            raise SystemExit(0)

        monkeypatch.setattr(pipeline.WanPipeline, "create",
                            staticmethod(create))
        with pytest.raises(SystemExit):
            main(base + flag)
        assert (seen["quant_linear"], seen["v_quant"], seen["dit_path"]) == (
            flag == ["--quant_linear"],
            "row" if flag == ["--v_quant", "row"] else "channel",
            "x.pth" if flag == ["--dit_path", "x.pth"] else None)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(base + flag)


def test_entry_points_default_to_the_card():
    """Every public entry point of the pipeline runs on the card unless the
    caller asks for the CPU."""
    import inspect

    from turbodiffusion_tpu_torch.inference.wan2_1_t2v import parse_arguments
    from turbodiffusion_tpu_torch.models import umt5, vae, wan
    from turbodiffusion_tpu_torch.pipelines import pipeline
    for fn in (pipeline.load_dit, pipeline.TextEncoder,
               pipeline.WanPipeline.create, wan.init_wan_params,
               vae.init_vae_params, umt5.init_umt5_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert parse_arguments(["--prompt", "x"]).device == "cuda"


@pytest.mark.parametrize("attention_type", ["sla", "sagesla"])
def test_pipeline_quant_linear_generates_on_cpu(attention_type):
    """WanPipeline.create(quant_linear=True) on the test model: every block
    linear is a W8A8 Int8Linear (fused qkv, proj_l left float) and a request
    gives a finite video in [0, 1]."""
    from turbodiffusion_tpu_torch.ops.quant import Int8Linear
    pipe = WanPipeline.create(model="test", attention_type=attention_type,
                              quant_linear=True, device="cpu")
    assert pipe.cfg.quant_linear
    for blk in pipe.dit.blocks:
        sa, ca = blk.self_attn, blk.cross_attn
        assert sa.q is None and isinstance(sa.qkv, Int8Linear)
        assert all(isinstance(m, Int8Linear) for m in (
            sa.o, ca.q, ca.k, ca.v, ca.o, blk.ffn.fc1, blk.ffn.fc2))
        assert isinstance(sa.proj_l, torch.nn.Linear)
    video = pipe.generate_t2v("a cat", GenerationConfig(
        num_steps=2, num_frames=5, resolution="tiny", aspect_ratio="1:1"))
    assert video.shape == (1, 3, 5, 64, 64)
    assert bool(torch.isfinite(video).all())
    assert float(video.min()) >= 0.0 and float(video.max()) <= 1.0
