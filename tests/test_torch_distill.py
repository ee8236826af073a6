"""rCM distillation in the PyTorch port against the JAX package.

The `test` model (`wan_test_config`, fp32, 2 layers), from JAX's init with
a non-zero head (zero, every velocity is 0 and the comparisons prove
nothing; tests/test_distill.py:22-26 does the same); the student and the
fake score are the teacher plus seeded noise, so that sCM's g, DMD's
(x0_fake - x0_teacher) and the critic's loss are all non-trivial. The port
cannot draw JAX's random numbers, so each loss is fed the draws JAX's loss
makes from its key (the key splits of distill.py, redone here). Tolerance:
relative error 1e-3 on F, t_F and every loss (fp32 sums in another order,
forward-mode through a softmax), as the reference's own JVP test.
Also the phase schedule, the EMA update, a student and a critic
iteration, and the CLI with a checkpoint round trip.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbodiffusion_tpu.models.wan import init_wan_params as init_wan_params_jax
from turbodiffusion_tpu.pipelines.pipeline import make_wan_cfg as make_wan_cfg_jax
from turbodiffusion_tpu.training import distill as DJ
from turbodiffusion_tpu.training.timesteps import LogNormal as LogNormalJax
from turbodiffusion_tpu_torch.models.wan import WanModel
from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
from turbodiffusion_tpu_torch.training import distill as D
from turbodiffusion_tpu_torch.training.data import write_tar_shard
from turbodiffusion_tpu_torch.training.train_step import make_optimizer
from turbodiffusion_tpu_torch.utils.jax_params import load_jax_params

X_SHAPE = (2, 16, 2, 4, 4)           # 8 tokens a sample
REL = 1e-3


def _trees(backend="original"):
    """JAX's init for `backend` (sla: topk 0.5, blocks 8/8, proj_l
    non-zero), the head seeded non-zero; the student and fake score are
    the teacher plus N(0, 0.02^2) noise on every leaf."""
    cfg_j = make_wan_cfg_jax("test", backend, 0.5)
    teacher = jax.tree.map(np.array, jax.jit(
        init_wan_params_jax, static_argnums=1)(jax.random.PRNGKey(0), cfg_j))
    r = np.random.RandomState(1)
    nodes = [(teacher["head"]["head"], 0.05)]
    if backend == "sla":
        nodes.append((teacher["blocks"]["self_attn"]["proj_l"], 0.2))
    for node, std in nodes:
        for leaf in ("w", "b"):
            node[leaf] = (std * r.randn(*node[leaf].shape)).astype(np.float32)
    noisy = [jax.tree.map(lambda a, s=s: a + 0.02 * np.random.RandomState(s)
                          .randn(*a.shape).astype(a.dtype), teacher)
             for s in (2, 3)]
    return cfg_j, teacher, noisy[0], noisy[1]


def _model(tree, backend="original"):
    return load_jax_params(WanModel(make_wan_cfg("test", backend, 0.5)), tree)


def _batch():
    r = np.random.RandomState(4)
    return (r.randn(*X_SHAPE).astype(np.float32),
            r.randn(2, 16, 32).astype(np.float32),
            r.randn(2, 16, 32).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _sim_draws_jax(key, shape, n, dcfg):
    """backward_simulation's draws from its key (distill.py:199-223)."""
    key, k0 = jax.random.split(key)
    x = jax.random.normal(k0, shape, jnp.float32)
    rf = []
    for _ in range(n - 1):
        if not dcfg.dmd_fix_timesteps:
            key, kt = jax.random.split(key)
            rf.append(LogNormalJax(dcfg.p_d_mean, dcfg.p_d_std)(kt, (shape[0], 1)))
    noise = []
    for _ in range(n - 1):
        key, kn = jax.random.split(key)
        noise.append(jax.random.normal(kn, shape, jnp.float32))
    return D.SimDraws(*_t(x), _t(*rf), _t(*noise))


def _dmd_draws_jax(key, shape, n, dcfg):
    """dmd_loss's / critic_loss's draws from their key."""
    k_sim, k_t, k_eps = jax.random.split(key, 3)
    rf = LogNormalJax(dcfg.p_d_mean, dcfg.p_d_std)(k_t, (shape[0], 1))
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    return D.DmdDraws(_sim_draws_jax(k_sim, shape, n, dcfg), *_t(rf, eps))


@pytest.mark.parametrize("backend", ["original", "sla"])
def test_denoise_and_student_tangent_match_jax(backend):
    """denoise's (x0, F) and the student's (F, t_F) by forward AD against
    JAX's jax.jvp (sla: the sparse tangent and the linear branch)."""
    cfg_j, teacher, student, _ = _trees(backend)
    dcfg = D.DistillConfig()
    r = np.random.RandomState(5)
    xt, t_xt = (r.randn(*X_SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([[0.9], [0.4]], np.float32)
    t_t = np.array([[0.3], [-0.2]], np.float32)
    cond = _batch()[1]
    jx = [jnp.asarray(a) for a in (xt, t_xt, t, t_t, cond)]
    pj = jax.tree.map(jnp.asarray, student)
    Fj, tFj = jax.jit(DJ.student_F_and_tangent, static_argnums=(1, 7))(
        pj, cfg_j, *jx, dcfg)
    net = _model(student, backend)
    xt_p, t_xt_p, t_p, t_t_p, cond_p = _t(xt, t_xt, t, t_t, cond)
    with torch.no_grad():
        x0, F = D.denoise(net, xt_p, t_p, cond_p, dcfg)
    Fp, tFp = D.student_F_and_tangent(net, xt_p, t_xt_p, t_p, t_t_p, cond_p,
                                      dcfg)
    assert net.cfg.attention.jvp_mode is False       # restored after the pass
    for name, got, want in (("F", F, Fj), ("jvp F", Fp, Fj), ("t_F", tFp, tFj)):
        assert _rel(got, want) < REL, (name, _rel(got, want))
    t5 = t_p[:, :, None, None, None]                 # distill.py:417-420
    torch.testing.assert_close(torch.cos(t5) * xt_p - torch.sin(t5) * F, x0,
                               rtol=1e-4, atol=1e-5)
    assert float(np.abs(np.asarray(tFj)).max()) > 1e-2


def _loss_pair(kind):
    """(port loss, JAX loss) of `kind` on one batch and one key."""
    guided = kind.endswith("uncond")
    dcfg = D.DistillConfig(teacher_guidance=5.0 if guided else 1.0,
                           max_simulation_steps_fake=2,
                           cm_type="dcm" if kind == "dcm" else "scm")
    dcfg_j = DJ.DistillConfig(**{f: getattr(dcfg, f) for f in
                                 dcfg.__dataclass_fields__})
    cfg_j, teacher, student, fake = _trees()
    x0, cond, uncond = _batch()
    uncond = uncond if guided else None
    pj = [jax.tree.map(jnp.asarray, t) for t in (student, teacher, fake)]
    nets = [_model(t) for t in (student, teacher, fake)]
    jb = [None if a is None else jnp.asarray(a) for a in (x0, cond, uncond)]
    pb = [None if a is None else torch.from_numpy(a) for a in (x0, cond, uncond)]
    key = jax.random.PRNGKey(7)
    if kind.startswith("scm"):
        want = DJ.scm_loss(pj[0], pj[1], cfg_j, dcfg_j, *jb, key, 3)
        k_t, k_eps = jax.random.split(key)
        draws = _t(LogNormalJax(dcfg.p_g_mean, dcfg.p_g_std)(k_t, (2, 1)),
                   jax.random.normal(k_eps, X_SHAPE, jnp.float32))
        got = D.scm_loss(nets[0], nets[1], *pb, *draws, 3, dcfg)
    elif kind == "dcm":
        want = DJ.dcm_loss(pj[0], pj[1], cfg_j, dcfg_j, *jb, key, 3)
        k_u, k_eps = jax.random.split(key)
        draws = _t(jax.random.uniform(k_u, (2, 1)),
                   jax.random.normal(k_eps, X_SHAPE, jnp.float32))
        got = D.dcm_loss(nets[0], nets[1], *pb, *draws, dcfg)
    elif kind.startswith("dmd"):
        want = DJ.dmd_loss(pj[0], pj[1], pj[2], cfg_j, dcfg_j, X_SHAPE, jb[1],
                           jb[2], key, 2)
        got = D.dmd_loss(nets[0], nets[1], nets[2], pb[1], pb[2],
                         _dmd_draws_jax(key, X_SHAPE, 2, dcfg), dcfg)
    else:
        want = DJ.critic_loss(pj[2], pj[0], cfg_j, dcfg_j, X_SHAPE, jb[1],
                              key, 2)
        got = D.critic_loss(nets[2], nets[0], pb[1],
                            _dmd_draws_jax(key, X_SHAPE, 2, dcfg), dcfg)
    return got, want


@pytest.mark.parametrize("kind", ["scm", "scm uncond", "dcm", "dmd uncond",
                                  "critic"])
def test_losses_match_jax_given_its_draws(kind):
    got, want = _loss_pair(kind)
    assert got.requires_grad                 # the trained net's graph is kept
    assert float(want) > 1e-3
    assert _rel(got.detach(), want) < REL, (float(got), float(want))


@pytest.mark.parametrize("it", range(13))
def test_phase_schedule_matches_jax(it):
    """Phase, effective iteration and simulation steps, with a tangent
    warmup of 2, an update frequency of 3 and up to 4 simulation steps."""
    kw = dict(tangent_warmup=2, student_update_freq=3,
              max_simulation_steps_fake=4)
    dcfg, dcfg_j = D.DistillConfig(**kw), DJ.DistillConfig(**kw)
    student = DJ.is_student_phase(it, dcfg_j, True)
    eff = DJ.effective_iteration(it, dcfg_j, True)
    n_sim = (eff if student else it - eff - 1) % 4 + 1   # distill.py:395-406
    assert D.is_student_phase(it, dcfg, True) == student
    assert D.effective_iteration(it, dcfg, True) == eff
    assert D.simulation_steps(it, dcfg, True) == n_sim
    assert D.is_student_phase(it, dcfg, False)           # no critic
    assert D.effective_iteration(it, dcfg, False) == it


def test_ema_update_matches_jax():
    """ema * beta + (1 - beta) * student in fp32 (distill.py:383-388), at
    beta = JAX's ema_beta(5, power_ema_gamma(0.15)); the expression is
    JAX's, evaluated in numpy float32."""
    _, teacher, student, _ = _trees()
    dcfg = D.DistillConfig()
    state = D.create_distill_state(_model(teacher), make_optimizer(), dcfg)
    moved = _model(student)
    state.student.load_state_dict(moved.state_dict())
    from turbodiffusion_tpu.training.timesteps import ema_beta, power_ema_gamma
    beta = ema_beta(5, power_ema_gamma(0.15))
    assert 0 < beta < 1
    before = {n: e.clone() for n, e in state.ema.items()}
    step = D.make_distill_steps(dcfg, make_optimizer())
    step.ema_update(state, beta)
    for n, p in state.student.named_parameters():
        # JAX's fp32 arithmetic, the Python floats taken as float32
        want = (before[n].numpy() * np.float32(beta)
                + np.float32(1.0 - beta) * p.detach().numpy())
        np.testing.assert_allclose(state.ema[n].numpy(), want,
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_student_then_critic_iteration():
    """Iteration 0 is a student iteration (sCM + DMD, then the EMA),
    iteration 1 a critic iteration: the student moves in the first only,
    the fake score in the second only, the teacher never. The fake score
    starts apart from the teacher, or DMD's loss and gradient are 0."""
    _, teacher, _, fake = _trees()
    dcfg = D.DistillConfig(student_update_freq=2, max_simulation_steps_fake=2,
                           teacher_guidance=1.0)
    state = D.create_distill_state(_model(teacher), make_optimizer(lr=1e-3),
                                   dcfg)
    state.fake_score.load_state_dict(_model(fake).state_dict())
    step = D.make_distill_steps(dcfg, make_optimizer(lr=1e-3))
    x0, cond, _ = _batch()
    batch = {"latents": torch.from_numpy(x0),
             "t5_text_embeddings": torch.from_numpy(cond)}
    snap = lambda m: {n: p.detach().clone() for n, p in m.named_parameters()}  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    t0, s0, f0 = snap(state.teacher), snap(state.student), snap(state.fake_score)
    e0 = {n: e.clone() for n, e in state.ema.items()}
    state, m0 = step(state, batch, gen)
    t1, s1, f1 = snap(state.teacher), snap(state.student), snap(state.fake_score)
    state, m1 = step(state, batch, gen)
    t2, s2, f2 = snap(state.teacher), snap(state.student), snap(state.fake_score)
    assert m0["student_phase"] == 1.0 and m1["student_phase"] == 0.0
    assert state.step == 2
    for k in ("loss", "loss_cm", "loss_dmd", "grad_norm"):
        assert np.isfinite(float(m0[k])) and float(m0[k]) > 0, k
    assert np.isfinite(float(m1["loss_critic"])) and float(m1["loss_critic"]) > 0
    moved = lambda a, b: sum(int(not torch.equal(a[n], b[n])) for n in a)  # noqa: E731
    assert moved(t0, t1) == moved(t1, t2) == 0
    assert moved(s0, s1) == len(s0) and moved(s1, s2) == 0
    assert moved(f0, f1) == 0 and moved(f1, f2) == len(f0)
    assert moved(e0, state.ema) == len(e0)


def test_cli_rcm_trains_and_resumes(tmp_path):
    """`--experiment rcm --device cpu` on the test model: 2 iterations
    (student, critic) saved each iteration, then a run that resumes from
    the second checkpoint with the student, fake score, EMA, both AdamW
    states and the generator as they were, and takes iteration 3."""
    from turbodiffusion_tpu_torch.scripts import train
    from turbodiffusion_tpu_torch.training.trainer import Callback
    r = np.random.RandomState(0)
    write_tar_shard(str(tmp_path / "shard-0000.tar"), [
        {"latents": r.randn(16, 2, 4, 4).astype(np.float32),
         "t5_text_embeddings": r.randn(16, 32).astype(np.float32),
         "prompts": f"sample {i}"} for i in range(2)])
    common = ["--experiment", "rcm", "--model", "test", "--device", "cpu",
              "--data", str(tmp_path / "*.tar"), "--ckpt_dir",
              str(tmp_path / "run"), "--save_every", "1", "--lr", "1e-3",
              "--metrics_jsonl", str(tmp_path / "m.jsonl")]
    ovr = ["--", "model.num_layers=1", "distill.student_update_freq=2",
           "distill.max_simulation_steps_fake=2", "trainer.log_every=1"]
    state = train.main(common + ["--max_iter", "2"] + ovr)
    assert state.step == 2 and len(state.student.blocks) == 1
    saved = {k: {n: t.clone() for n, t in v.items()} for k, v in (
        ("student", state.student.state_dict()),
        ("fake", state.fake_score.state_dict()), ("ema", state.ema))}
    moments = [state.opt_fake.adamw.state[p]["exp_avg"].clone()
               for p in state.opt_fake.params]
    got = {}

    class Resumed(Callback):
        def on_train_start(self, st):
            got["step"] = st.step
            got["student"] = all(torch.equal(t, saved["student"][n]) for n, t
                                 in st.student.state_dict().items())
            got["fake"] = all(torch.equal(t, saved["fake"][n]) for n, t
                              in st.fake_score.state_dict().items())
            got["ema"] = all(torch.equal(t, saved["ema"][n])
                             for n, t in st.ema.items())
            got["moments"] = all(torch.equal(st.opt_fake.adamw.state[p][
                "exp_avg"], m) for p, m in zip(st.opt_fake.params, moments))

    state = train.main(common + ["--max_iter", "3"] + ovr,
                       callbacks=[Resumed()])
    assert got == {"step": 2, "student": True, "fake": True, "ema": True,
                   "moments": True}
    assert state.step == 3
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "run" / "iter_*.pth"))) == [
        f"iter_{i:09d}.pth" for i in (1, 2, 3)]
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"loss_cm"' in lines[0] \
        and '"loss_critic"' in lines[1]
