"""SLA fine-tuning in the PyTorch port against the JAX package.

A 2-layer `test`-config `sla` student (topk 0.5, blocks 8/8) and `original`
teacher, fp32, from JAX's init with the head and `proj_l` made non-zero
(zero, they make every gradient upstream of them vanish and the comparison
prove nothing). The port cannot draw JAX's random numbers, so the RF times
and the noise JAX's step draws from its key are drawn here with the same
key and fed to the port's step. Tolerances as tests/test_wan_model.py:
loss rtol 1e-5, gradients rtol 1e-4 + atol 1e-6; what two AdamW steps
(warmup and clipping on) moved the parameters by, atol 2.4e-7 + rtol 1e-5:
updates of ~5e-4, and two fp32 steps (2^-22) of parameters up to ~1, since
optax adds one combined update where torch's AdamW decays the parameter
and then steps it, rounding twice.
Also the data pipeline, the trainer loop with a resume, the CLI, the
optimizer chain and the refusals.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.models.wan import init_wan_params as init_wan_params_jax
from turbodiffusion_tpu.models.wan import wan_forward
from turbodiffusion_tpu.pipelines.pipeline import make_wan_cfg as make_wan_cfg_jax
from turbodiffusion_tpu.training import data as data_jax
from turbodiffusion_tpu.training import timesteps as ts_jax
from turbodiffusion_tpu.training import train_step as step_jax
from turbodiffusion_tpu_torch.config import WanConfig
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
from turbodiffusion_tpu_torch.training import timesteps as ts
from turbodiffusion_tpu_torch.training.checkpointing import Checkpointer
from turbodiffusion_tpu_torch.training.data import (
    WebDatasetLoader, iter_tar_samples, write_tar_shard)
from turbodiffusion_tpu_torch.training.train_step import (
    TrainState, lambda_linear_schedule, make_optimizer, make_sla_train_step,
    make_train_step, sla_step_loss)
from turbodiffusion_tpu_torch.training.trainer import (
    DeviceMonitor, EveryNDrawSample, GradNormMonitor, HeartBeat, Trainer,
    TrainerConfig)
from turbodiffusion_tpu_torch.utils.jax_params import (
    load_jax_params, port_layout)

TOPK = 0.5
X_SHAPE = (1, 16, 2, 8, 8)                 # 32 tokens: 4 Q / K blocks of 8


def _trees():
    """JAX's init for the sla student (its tree also serves the dense
    teacher, which reads no proj_l), head and proj_l seeded non-zero."""
    cfg_j = make_wan_cfg_jax("test", "sla", TOPK)
    params = jax.tree.map(np.array, jax.jit(
        init_wan_params_jax, static_argnums=1)(jax.random.PRNGKey(0), cfg_j))
    r = np.random.RandomState(1)
    for node, std in ((params["head"]["head"], 0.05),
                      (params["blocks"]["self_attn"]["proj_l"], 0.2)):
        for leaf in ("w", "b"):
            node[leaf] = (std * r.randn(*node[leaf].shape)).astype(np.float32)
    return cfg_j, params


def _models(params, remat="none"):
    cfg_s = make_wan_cfg("test", "sla", TOPK).replace(remat=remat)
    cfg_t = make_wan_cfg("test", "original")
    return (load_jax_params(WanModel(cfg_s), params),
            load_jax_params(WanModel(cfg_t), params).requires_grad_(False))


def _batch():
    r = np.random.RandomState(2)
    return {"latents": r.randn(*X_SHAPE).astype(np.float32),
            "t5_text_embeddings": r.randn(1, 16, 32).astype(np.float32)}


def _draws(key):
    """The draws of JAX's `make_sla_train_step` from `key`
    (train_step.py:77-80)."""
    k_t, k_eps = jax.random.split(key)
    rf_t = ts_jax.LogNormal(0.0, 1.6)(k_t, (1, 1))
    eps = jax.random.normal(k_eps, X_SHAPE, jnp.float32)
    return np.asarray(rf_t), np.asarray(eps)


def _jax_loss_and_grads(cfg_j, params, batch, rf_t, eps):
    cfg_t = make_wan_cfg_jax("test", "original")
    x0 = jnp.asarray(batch["latents"])
    emb = jnp.asarray(batch["t5_text_embeddings"])
    t5 = jnp.asarray(rf_t)[:, :, None, None, None]
    xt = (1.0 - t5) * x0 + t5 * jnp.asarray(eps)
    tt = jnp.asarray(rf_t) * 1000.0
    pj = jax.tree.map(jnp.asarray, params)
    v_teacher = wan_forward(pj, cfg_t, xt, tt, emb)

    def loss_fn(p):
        return jnp.mean((wan_forward(p, cfg_j, xt, tt, emb) - v_teacher) ** 2)
    return jax.jit(jax.value_and_grad(loss_fn))(pj)


def _port_loss_and_grads(student, teacher, batch, rf_t, eps):
    student.zero_grad(set_to_none=True)
    loss = sla_step_loss(student, teacher,
                         *(torch.from_numpy(batch[k]) for k in
                           ("latents", "t5_text_embeddings")),
                         torch.from_numpy(rf_t), torch.from_numpy(eps))
    loss.backward()
    return loss, {n: p.grad for n, p in student.named_parameters()}


def test_sla_loss_and_every_gradient_match_jax():
    cfg_j, params = _trees()
    batch = _batch()
    rf_t, eps = _draws(jax.random.PRNGKey(5))
    loss_j, grads_j = _jax_loss_and_grads(cfg_j, params, batch, rf_t, eps)
    student, teacher = _models(params)
    loss, grads = _port_loss_and_grads(student, teacher, batch, rf_t, eps)
    assert float(loss_j) > 1e-4                # the seeded head is live
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = port_layout(student, jax.tree.map(np.asarray, grads_j))
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert g is not None, f"{name}: no gradient"
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for lin in ("q", "k", "v", "proj_l"):
        for i in range(2):
            g = grads[f"blocks.{i}.self_attn.{lin}.weight"]
            assert g.abs().max() > 1e-6, f"block {i} {lin}: zero gradient"


def test_remat_block_wise_gives_the_same_loss_and_gradients():
    _, params = _trees()
    batch = _batch()
    rf_t, eps = _draws(jax.random.PRNGKey(6))
    runs = [_port_loss_and_grads(*_models(params, remat), batch, rf_t, eps)
            for remat in ("none", "block_wise")]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_two_optimizer_steps_match_optax():
    """make_sla_train_step twice with warmup 2 (lr x 1e-6, then x 0.5) and
    clipping at 1e-3 (below the gradients' norm), against JAX's step."""
    cfg_j, params = _trees()
    cfg_t = make_wan_cfg_jax("test", "original")
    batch = _batch()
    opt_kw = dict(lr=1e-3, warmup_steps=2, grad_clip=1e-3)
    opt_j = step_jax.make_optimizer(**opt_kw)
    pj = jax.tree.map(jnp.asarray, params)
    state_j = step_jax.TrainState(pj, opt_j.init(pj), jnp.zeros((), jnp.int32))
    step_j = step_jax.make_sla_train_step(cfg_j, cfg_t, pj, opt_j)
    student, teacher = _models(params)
    opt = make_optimizer(**opt_kw)
    state = TrainState(student, opt.init(student))
    step = make_sla_train_step(teacher, opt)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        state_j, _ = step_j(state_j, batch, key)
        rf_t, eps = _draws(key)
        state, metrics = step.apply(state, tb, torch.from_numpy(rf_t),
                                    torch.from_numpy(eps))
        assert float(metrics["grad_norm"]) > 1e-3          # clipping bites
    assert state.step == 2 and int(state_j.step) == 2
    want = port_layout(student, jax.tree.map(np.asarray, state_j.params))
    moved = 0
    for name, p in student.named_parameters():
        d_port = (p.detach() - before[name]).numpy()
        d_jax = want[name] - before[name].numpy()
        np.testing.assert_allclose(d_port, d_jax, atol=2.4e-7, rtol=1e-5,
                                   err_msg=name)
        moved += int(np.abs(d_jax).max() > 0)
    assert moved == len(before)


def test_optimizer_chain_filters_and_clips():
    """LR warmup (rcm/utils/lr_scheduler.py) and the NaN filter + clip
    (rcm/callbacks/grad_clip.py:27-61), as tests/test_training_infra.py."""
    sched = lambda_linear_schedule(1e-4, warmup_steps=100)
    sched_j = step_jax.lambda_linear_schedule(1e-4, warmup_steps=100)
    for s in (0, 1, 50, 99, 100, 500):
        np.testing.assert_allclose(sched(s), float(sched_j(s)), rtol=1e-6)
    lin = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(1.0)
    opt = make_optimizer(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    st = opt.init(lin)
    lin.weight.grad = torch.tensor([[float("nan"), float("inf"), 100., -100.]])
    metrics = opt.update(st)
    assert torch.isfinite(lin.weight).all()
    np.testing.assert_allclose(float(metrics["grad_norm"]), 100 * 2 ** 0.5,
                               rtol=1e-6)
    # a parameter with no gradient takes a zero one: weight decay still acts
    lin2 = torch.nn.Linear(2, 1, bias=False)
    opt2 = make_optimizer(lr=0.5, weight_decay=0.1)
    st2 = opt2.init(lin2)
    w0 = lin2.weight.detach().clone()
    opt2.update(st2)
    torch.testing.assert_close(lin2.weight.detach(), w0 * (1 - 0.05))


def test_timesteps_match_jax():
    x = np.linspace(0.01, 0.99, 7).astype(np.float32)
    for name in ("rf_to_sigma", "rf_to_trig_time", "trig_to_rf_time"):
        np.testing.assert_allclose(getattr(ts, name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(ts_jax, name)(x)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(ts.shift_rf_time(torch.from_numpy(x), 5.0).numpy(),
                               np.asarray(ts_jax.shift_rf_time(x, 5.0)), rtol=1e-6)
    for a, b in zip(ts.trigflow_scaling(torch.from_numpy(x)),
                    ts_jax.trigflow_scaling(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert ts.power_ema_gamma(0.05) == ts_jax.power_ema_gamma(0.05)
    assert ts.ema_beta(10, 6.9) == ts_jax.ema_beta(10, 6.9)
    g = torch.Generator().manual_seed(0)
    rf = ts.LogNormal(0.0, 1.6)(g, (4096, 1))
    assert rf.shape == (4096, 1) and 0 <= float(rf.min()) and float(rf.max()) <= 1
    # LogNormal(0, s) in the RF domain has median sigma 1, i.e. rf_t 0.5
    assert abs(float(rf.median()) - 0.5) < 0.05
    u = ts.UniformShift(3.0)(g, (8,))
    assert ((u >= 0) & (u <= 1)).all()


def _shards(tmp, n_shards=2, per_shard=4):
    paths = []
    for s in range(n_shards):
        r = np.random.RandomState(s)
        samples = [{"latents": r.randn(16, 2, 4, 4).astype(np.float32),
                    "t5_text_embeddings": r.randn(16, 32).astype(np.float32),
                    "prompts": f"shard{s} sample{i}"} for i in range(per_shard)]
        paths.append(os.path.join(tmp, f"shard-{s:04d}.tar"))
        write_tar_shard(paths[-1], samples)
    return paths


def test_tar_round_trip_reads_the_same_as_jax(tmp_path):
    path = _shards(str(tmp_path), 1, 3)[0]
    got = list(iter_tar_samples(path))
    want = list(data_jax.iter_tar_samples(path, native=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["prompts"] == b["prompts"]
        for k in ("latents", "t5_text_embeddings"):
            assert a[k].dtype == torch.float32
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    # a shard JAX's writer made reads back the same through the port
    jpath = str(tmp_path / "jax.tar")
    data_jax.write_tar_shard(jpath, want)
    again = list(iter_tar_samples(jpath))
    np.testing.assert_array_equal(again[2]["latents"].numpy(), want[2]["latents"])


def test_loader_batching_and_host_split(tmp_path):
    paths = _shards(str(tmp_path), 4, 2)
    batches = list(WebDatasetLoader(paths, 2, loop=False, shuffle=False,
                                    device="cpu"))
    assert len(batches) == 4
    assert batches[0]["latents"].shape == (2, 16, 2, 4, 4)
    assert torch.is_tensor(batches[0]["latents"])
    parts = [{p for b in WebDatasetLoader(paths, 2, host_id=h, num_hosts=2,
                                          loop=False, shuffle=False,
                                          device="cpu")
              for p in b["prompts"]} for h in (0, 1)]
    assert parts[0].isdisjoint(parts[1]) and len(parts[0] | parts[1]) == 8
    # the shuffle follows seed + epoch, as JAX's
    lp = WebDatasetLoader(paths, 2, seed=3, device="cpu")
    lj = data_jax.WebDatasetLoader(paths, 2, seed=3)
    assert lp._epoch_shards(1) == lj._epoch_shards(1)


def test_loader_default_device_is_the_card(tmp_path):
    """Like every entry point of the port, the loader puts its batches on
    the card unless the caller asks for the CPU."""
    paths = _shards(str(tmp_path), 1, 1)
    assert WebDatasetLoader(paths, 1).device == torch.device("cuda")
    assert WebDatasetLoader(paths, 1, device="cpu").device == torch.device("cpu")


def test_trainer_loop_with_checkpoint_resume(tmp_path):
    """tests/test_training_infra.py:55-91: three steps saving every two, a
    restore into a fresh state, and the generator's state with them."""
    _, params = _trees()
    student, _ = _models(params)
    opt = make_optimizer(lr=1e-4)
    state = TrainState(student, opt.init(student))
    step = make_train_step(opt)
    r = np.random.RandomState(0)
    batch = {"latents": torch.from_numpy(r.randn(*X_SHAPE).astype(np.float32)),
             "teacher_velocity": torch.zeros(X_SHAPE),
             "t5_text_embeddings": torch.from_numpy(
                 r.randn(1, 16, 32).astype(np.float32)),
             "timesteps": torch.full((1, 1), 700.0)}
    ckpt = Checkpointer(str(tmp_path / "ckpt"), async_save=True)
    gnorms = GradNormMonitor()
    gen = torch.Generator().manual_seed(1)
    trainer = Trainer(TrainerConfig(max_iter=3, save_every=2, log_every=100),
                      step, checkpointer=ckpt, callbacks=[gnorms])
    state = trainer.train(state, iter(lambda: batch, None), gen)
    assert state.step == 3 and ckpt.latest_step() == 3 and ckpt.steps() == [2, 3]
    assert len(gnorms.history) == 3 and all(g > 0 for g in gnorms.history)
    assert (tmp_path / "ckpt" / "latest_checkpoint.txt").read_text() == \
        "iter_000000003"
    fresh, _ = _models(_trees()[1])
    template = TrainState(fresh, opt.init(fresh))
    gen2 = torch.Generator().manual_seed(99)
    restored, at = ckpt.restore(template, generator=gen2)
    assert at == 3 and restored.step == 3
    for (n, a), b in zip(state.params.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(gen2.get_state(), gen.get_state())
    m0 = state.opt_state.adamw.state_dict()["state"][0]["exp_avg"]
    assert torch.equal(restored.opt_state.adamw.state_dict()["state"][0]["exp_avg"], m0)


def test_cli_trains_two_steps_and_resumes(tmp_path):
    from turbodiffusion_tpu_torch.scripts import train
    _shards(str(tmp_path), 1, 2)
    common = ["--experiment", "sla", "--model", "test", "--device", "cpu",
              "--data", os.path.join(str(tmp_path), "*.tar"),
              "--ckpt_dir", str(tmp_path / "run"), "--save_every", "1",
              "--metrics_jsonl", str(tmp_path / "m.jsonl")]
    state = train.main(common + ["--max_iter", "2", "--remat", "block_wise",
                                 "--", "trainer.log_every=1", "model.num_layers=1"])
    assert state.step == 2 and len(state.params.blocks) == 1
    # the student keeps its linear branch though every proj_l is zero
    assert state.params.cfg.attention.linear_branch
    assert state.params.blocks[0].self_attn.proj_l.weight.grad is not None
    state = train.main(common + ["--max_iter", "3", "--", "model.num_layers=1"])
    assert state.step == 3
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "run" / "iter_*.pth"))) == [
        f"iter_{i:09d}.pth" for i in (1, 2, 3)]
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"loss"' in lines[0]


def test_cli_and_config_refuse_what_is_not_ported(tmp_path):
    from turbodiffusion_tpu_torch.scripts import train
    base = ["--model", "test", "--device", "cpu", "--data", "none/*.tar"]
    with pytest.raises(NotImplementedError, match="item 12"):
        train.main(["--experiment", "sla", "--mesh", "1,4,2"] + base)
    for mode in ("mm_only", "attn_only", "self_attn_only"):
        with pytest.raises(NotImplementedError, match="item 11b"):
            WanConfig(remat=mode)
        with pytest.raises(NotImplementedError, match="item 11b"):
            train.main(["--experiment", "sla", "--remat", mode] + base)
    with pytest.raises(ValueError, match="unknown remat"):
        WanConfig(remat="everything")


def test_callbacks(tmp_path):
    from types import SimpleNamespace
    hb = HeartBeat(str(tmp_path / "hb.txt"), every_secs=0.0)
    hb.on_training_step_end(None, {}, 7)
    assert (tmp_path / "hb.txt").read_text().startswith("7 ")
    mon = DeviceMonitor(every_n=2)
    snap = DeviceMonitor.snapshot()
    assert snap["devices"] and snap.get("host_rss_kb", 0) > 0
    metrics = {}
    mon.on_training_step_end(None, metrics, 1)
    assert mon.last == {}
    mon.on_training_step_end(None, metrics, 2)
    assert mon.last["devices"] and "device_bytes_in_use" in metrics
    drawn = []
    cb = EveryNDrawSample(1, lambda p, tag, it: drawn.append((p, tag)))
    cb.on_training_step_end(SimpleNamespace(student="s", ema="e"), {}, 1)
    assert drawn == [("s", "reg"), ("e", "ema")]
    drawn.clear()
    cb.on_training_step_end(SimpleNamespace(student=None, params="p"), {}, 1)
    assert drawn == [("p", "reg")]
    drawn.clear()
    cb.on_training_step_end(SimpleNamespace(), {}, 1)       # warns, no raise
    assert not drawn


def test_load_ema_as_params_prefers_the_ema_model():
    from types import SimpleNamespace
    from turbodiffusion_tpu_torch.training.checkpointing import (
        load_ema_as_params)
    assert load_ema_as_params(SimpleNamespace(ema="e", student="s")) == "e"
    assert load_ema_as_params(SimpleNamespace(ema=None, student="s")) == "s"
