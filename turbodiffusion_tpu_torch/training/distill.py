"""rCM distillation: sCM / dCM consistency losses and DMD with a fake-score
critic.

Ports `turbodiffusion_tpu/training/distill.py` (behavioural reference
rcm/models/t2v_model_distill_rcm.py). Three `WanModel`s share one config:
the student (trained), the frozen teacher and the fake-score critic, both
trained nets initialised from the teacher. A student iteration is the sCM
(or dCM) loss plus DMD, followed by a power EMA of the student; a critic
iteration is the fake-score denoising loss; `student_update_freq` sets the
alternation.

The sCM tangent is a forward-mode JVP through the whole student:
`student_F_and_tangent` runs it with `torch.autograd.forward_ad` dual
tensors under `torch.no_grad()` (JAX stop-gradients the parameters and
t_F, distill.py:98, :129-130, so no reverse graph is built) and with the
model in `jvp_mode`, where attention's tangent rule is one K25 (dense) or
K26 (block-sparse) launch a call.

The port's state is modules and torch optimizers where JAX's is parameter
trees and optax states: `DistillState` holds the three models, the fp32
EMA of the student (a dict of tensors by parameter name) and the two
optimizer states, updated in place. Randomness comes from a
`torch.Generator`; each loss is a function of its draws (times, noise, the
simulation's draws), and `make_distill_steps` returns the step given its
draws beside the step that draws them, so the tests feed JAX's draws.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from turbodiffusion_tpu_torch.models.wan import jvp_mode
from turbodiffusion_tpu_torch.training.timesteps import (
    LogNormal, ema_beta, power_ema_gamma, rf_to_trig_time, shift_rf_time,
    trigflow_scaling)
from turbodiffusion_tpu_torch.training.train_step import (
    OptState, Optimizer, _PhaseClock)


@dataclass(frozen=True)
class DistillConfig:
    """T2VDistillConfig_rCM (distill.py:34-56)."""
    teacher_guidance: float = 5.0
    tangent_warmup: int = 0
    loss_scale: float = 100.0
    loss_scale_dmd: float = 1.0
    student_update_freq: int = 5
    max_simulation_steps_fake: int = 4
    p_g_mean: float = -0.8
    p_g_std: float = 1.6
    p_d_mean: float = 0.0
    p_d_std: float = 1.6
    t_scaling_factor: float = 1000.0
    backward_timesteps: Tuple[float, ...] = (1.5, 1.4, 1.0)
    dmd_fix_timesteps: bool = False
    cm_type: str = "scm"           # "scm" | "dcm"
    dcm_total_steps: int = 48
    dcm_skipping_interval_steps: int = 1
    dcm_timestep_shift: float = 5.0
    ema_rate: float = 0.15
    ema_enabled: bool = True
    ema_iteration_shift: int = 0


def _bcast(t_B1):
    return t_B1[:, :, None, None, None]            # (B, 1) -> (B, 1, 1, 1, 1)


def _sum_per_sample(x):
    return x.sum(dim=(1, 2, 3, 4))


# ---------------------------------------------------------------------------
# Denoiser (EDM-style preconditioning of the RF-trained net)
# ---------------------------------------------------------------------------

def denoise(net: nn.Module, xt, trig_t_B1, cond, dcfg: DistillConfig):
    """(x0_pred, F_pred) in fp32 at TrigFlow time trig_t (B, 1)
    (distill.py:66-76)."""
    t = _bcast(trig_t_B1.float())
    c_skip, c_out, c_in, c_noise = trigflow_scaling(t, dcfg.t_scaling_factor)
    net_out = net((xt * c_in).to(net.cfg.dtype), c_noise[:, 0, :, 0, 0],
                  cond).float()
    x0 = c_skip * xt + c_out * net_out
    F = (torch.cos(t) * xt - x0) / torch.sin(t)
    return x0, F


def student_F_and_tangent(student: nn.Module, xt, t_xt, trig_t_B1,
                          t_trig_t_B1, cond, dcfg: DistillConfig):
    """(F, t_F): the student's F and its JVP along (t_xt, t_trig_t)
    (distill.py:79-98), by forward AD through the model in `jvp_mode`,
    without gradients."""
    with torch.no_grad(), jvp_mode(student), fwAD.dual_level():
        _, F = denoise(student, fwAD.make_dual(xt, t_xt),
                       fwAD.make_dual(trig_t_B1, t_trig_t_B1), cond, dcfg)
        F, t_F = fwAD.unpack_dual(F)
    return F, t_F


# ---------------------------------------------------------------------------
# Random draws (what JAX's losses draw from their keys)
# ---------------------------------------------------------------------------

class SimDraws(NamedTuple):
    """`backward_simulation`'s draws: the initial noise, the n_steps - 1
    intermediate RF times (none with dmd_fix_timesteps) and the n_steps - 1
    re-noising draws."""
    x: torch.Tensor
    rf_t: List[torch.Tensor]
    noise: List[torch.Tensor]


class DmdDraws(NamedTuple):
    """The draws of `dmd_loss` and `critic_loss`: the simulation's, the RF
    time (B, 1) of the critic's noise level and its noise."""
    sim: SimDraws
    rf_t: torch.Tensor
    eps: torch.Tensor


def scm_draws(x0, dcfg: DistillConfig, g: Optional[torch.Generator]):
    """sCM's (rf_t (B, 1) ~ LogNormal(p_g), eps ~ N(0, 1) like x0)."""
    rf_t = LogNormal(dcfg.p_g_mean, dcfg.p_g_std)(g, (x0.shape[0], 1),
                                                   x0.device)
    return rf_t, torch.randn(x0.shape, generator=g, device=x0.device)


def dcm_draws(x0, dcfg: DistillConfig, g: Optional[torch.Generator]):
    """dCM's (u (B, 1) ~ U[0, 1), eps ~ N(0, 1) like x0)."""
    u = torch.rand((x0.shape[0], 1), generator=g, device=x0.device)
    return u, torch.randn(x0.shape, generator=g, device=x0.device)


def sim_draws(shape, n_steps: int, dcfg: DistillConfig,
              g: Optional[torch.Generator], device) -> SimDraws:
    n_t = 0 if dcfg.dmd_fix_timesteps else n_steps - 1
    d = LogNormal(dcfg.p_d_mean, dcfg.p_d_std)
    return SimDraws(
        torch.randn(shape, generator=g, device=device),
        [d(g, (shape[0], 1), device) for _ in range(n_t)],
        [torch.randn(shape, generator=g, device=device)
         for _ in range(n_steps - 1)])


def dmd_draws(shape, n_sim: int, dcfg: DistillConfig,
              g: Optional[torch.Generator], device) -> DmdDraws:
    sim = sim_draws(shape, n_sim, dcfg, g, device)
    rf_t = LogNormal(dcfg.p_d_mean, dcfg.p_d_std)(g, (shape[0], 1), device)
    return DmdDraws(sim, rf_t, torch.randn(shape, generator=g, device=device))


# ---------------------------------------------------------------------------
# Losses, each given its draws
# ---------------------------------------------------------------------------

def _guided(net, x, t, cond, uncond, dcfg: DistillConfig, index: int):
    """denoise()[index] with classifier-free guidance when an uncond is
    given and teacher_guidance > 1 (no gradient)."""
    with torch.no_grad():
        out = denoise(net, x, t, cond, dcfg)[index]
        if dcfg.teacher_guidance > 1.0 and uncond is not None:
            un = denoise(net, x, t, uncond, dcfg)[index]
            out = un + dcfg.teacher_guidance * (out - un)
    return out


def scm_loss(student, teacher, x0, cond, uncond, rf_t, eps, iteration: int,
             dcfg: DistillConfig, clock: Optional[_PhaseClock] = None):
    """Continuous-time consistency (sCM) loss (distill.py:105-156, the
    reference's fd_type=0 JVP path) given its draws."""
    clock = clock or _PhaseClock()
    trig_t = rf_to_trig_time(rf_t)
    t5 = _bcast(trig_t)
    cost, sint = torch.cos(t5), torch.sin(t5)
    xt = x0 * cost + eps * sint
    F_teacher = _guided(teacher, xt, trig_t, cond, uncond, dcfg, 1)
    clock.mark("teacher")

    # JVP rearrangement (arXiv 2410.11081 §5.1): the tangent directions
    t_xt = cost * sint * F_teacher
    t_t = (cost * sint)[:, 0, :, 0, 0]
    _, t_F_theta = student_F_and_tangent(student, xt, t_xt, trig_t, t_t, cond,
                                         dcfg)
    clock.mark("tangent")

    _, F_theta = denoise(student, xt, trig_t, cond, dcfg)
    F_sg = F_theta.detach()
    w = 1.0 if dcfg.tangent_warmup == 0 else min(
        1.0, iteration / dcfg.tangent_warmup)
    g = -cost * torch.sqrt(1 - w ** 2 * sint ** 2) * (F_sg - F_teacher) - (
        w * cost * sint * xt + t_F_theta)

    # NaN masking (distill.py:139-146)
    mask = (torch.isnan(g.flatten(1)).any(1)
            | torch.isnan(F_sg.flatten(1)).any(1))[:, None, None, None, None]
    g = torch.where(mask, 0.0, g)
    F_theta = torch.where(mask, 0.0, F_theta)
    F_sg = torch.where(mask, 0.0, F_sg)
    gnorm = torch.sqrt((g ** 2).sum(dim=(1, 2, 3, 4), keepdim=True))
    g = g / (gnorm + 0.1)
    loss = dcfg.loss_scale * _sum_per_sample((F_theta - F_sg - g) ** 2).mean()
    clock.mark("student_forward")
    return loss


def dcm_loss(student, teacher, x0, cond, uncond, u, eps, dcfg: DistillConfig,
             clock: Optional[_PhaseClock] = None):
    """Discrete-time consistency (dCM) loss (distill.py:159-193) given its
    draws: u (B, 1) uniform in [0, 1), eps like x0."""
    clock = clock or _PhaseClock()
    du = 1.0 / dcfg.dcm_total_steps
    u = u * (1.0 - dcfg.dcm_skipping_interval_steps * du)
    trig_ts = [rf_to_trig_time(shift_rf_time(1.0 - (u + kk * du),
                                             dcfg.dcm_timestep_shift))
               for kk in range(dcfg.dcm_skipping_interval_steps + 1)]
    t0, tN = trig_ts[0], trig_ts[-1]
    xt = torch.cos(_bcast(t0)) * x0 + torch.sin(_bcast(t0)) * eps
    x0_pred, _ = denoise(student, xt, t0, cond, dcfg)
    clock.mark("student_forward")
    xk = xt
    for kk in range(dcfg.dcm_skipping_interval_steps):
        tk, tk1 = trig_ts[kk], trig_ts[kk + 1]
        xk = xk - _bcast(tk - tk1) * _guided(teacher, xk, tk, cond, uncond,
                                             dcfg, 1)
    with torch.no_grad():
        x0_target, _ = denoise(student, xk, tN, cond, dcfg)
    clock.mark("teacher")
    return dcfg.loss_scale * _sum_per_sample((x0_pred - x0_target) ** 2).mean()


def backward_simulation(student, dcfg: DistillConfig, cond, draws: SimDraws,
                        with_grad: bool):
    """1..n-step student sampling from pure noise, TrigFlow re-noising
    between steps (distill.py:196-224); n = len(draws.noise) + 1. With
    with_grad only the last step builds a graph, as JAX stop-gradients the
    others."""
    x = draws.x
    B = x.shape[0]
    n_steps = len(draws.noise) + 1
    t_traj = [torch.full((B, 1), math.pi / 2, device=x.device)]
    for i in range(n_steps - 1):
        if dcfg.dmd_fix_timesteps:
            t_traj.append(torch.full((B, 1), dcfg.backward_timesteps[i],
                                     device=x.device))
        else:
            t_traj.append(torch.minimum(rf_to_trig_time(draws.rf_t[i]),
                                        t_traj[-1]))
    t_traj.append(torch.zeros((B, 1), device=x.device))
    for step in range(n_steps):
        with torch.set_grad_enabled(with_grad and step == n_steps - 1
                                    and torch.is_grad_enabled()):
            x, _ = denoise(student, x, t_traj[step], cond, dcfg)
        if step < n_steps - 1:
            tn5 = _bcast(t_traj[step + 1])
            x = torch.cos(tn5) * x.detach() + torch.sin(tn5) * draws.noise[step]
    return x


def dmd_loss(student, teacher, fake, cond, uncond, draws: DmdDraws,
             dcfg: DistillConfig, clock: Optional[_PhaseClock] = None):
    """Distribution-matching loss (distill.py:227-260) given its draws."""
    clock = clock or _PhaseClock()
    G_x0 = backward_simulation(student, dcfg, cond, draws.sim, with_grad=True)
    D_t = rf_to_trig_time(draws.rf_t)
    t5 = _bcast(D_t)
    D_xt = (torch.cos(t5) * G_x0 + torch.sin(t5) * draws.eps).detach()
    with torch.no_grad():
        x0_fake, _ = denoise(fake, D_xt, D_t, cond, dcfg)
    x0_teacher = _guided(teacher, D_xt, D_t, cond, uncond, dcfg, 0)
    G_sg = G_x0.detach()
    weight = torch.clamp((G_sg - x0_teacher).abs().mean(dim=(1, 2, 3, 4),
                                                        keepdim=True), min=1e-5)
    target = G_sg - (x0_fake - x0_teacher) / weight
    loss = (G_x0 - target) ** 2
    nan = torch.isnan(loss.detach().flatten(1)).any(1)
    loss = torch.where(nan[:, None, None, None, None], 0.0, loss)
    clock.mark("dmd")
    return dcfg.loss_scale_dmd * _sum_per_sample(loss).mean()


def critic_loss(fake, student, cond, draws: DmdDraws, dcfg: DistillConfig,
                clock: Optional[_PhaseClock] = None):
    """Fake-score (critic) denoising loss (distill.py:263-281) given its
    draws."""
    clock = clock or _PhaseClock()
    with torch.no_grad():
        G_x0 = backward_simulation(student, dcfg, cond, draws.sim,
                                   with_grad=False)
    clock.mark("simulation")
    D_t = rf_to_trig_time(draws.rf_t)
    t5 = _bcast(D_t)
    cost, sint = torch.cos(t5), torch.sin(t5)
    x0_fake, _ = denoise(fake, cost * G_x0 + sint * draws.eps, D_t, cond, dcfg)
    loss = _sum_per_sample((G_x0 - x0_fake) ** 2 / sint ** 2).mean()
    clock.mark("fake_forward")
    return loss


# ---------------------------------------------------------------------------
# Phase scheduling and state
# ---------------------------------------------------------------------------

def is_student_phase(iteration: int, dcfg: DistillConfig,
                     has_fake: bool) -> bool:
    """(distill.py:288-293)."""
    return ((not has_fake or dcfg.loss_scale_dmd == 0)
            or iteration < dcfg.tangent_warmup
            or (iteration - dcfg.tangent_warmup) % dcfg.student_update_freq == 0)


def effective_iteration(iteration: int, dcfg: DistillConfig,
                        has_fake: bool) -> int:
    if not has_fake or iteration < dcfg.tangent_warmup:
        return iteration
    return dcfg.tangent_warmup + (
        (iteration - dcfg.tangent_warmup) // dcfg.student_update_freq)


def simulation_steps(iteration: int, dcfg: DistillConfig,
                     has_fake: bool) -> int:
    """n_sim of the iteration's phase (distill.py:395-406): the student's
    from its effective iteration, the critic's from the critic iterations
    before it."""
    eff = effective_iteration(iteration, dcfg, has_fake)
    if not is_student_phase(iteration, dcfg, has_fake):
        eff = iteration - eff - 1
    return eff % dcfg.max_simulation_steps_fake + 1


@dataclasses.dataclass
class DistillState:
    """JAX's DistillState (distill.py:296-303): the three models, the
    student's fp32 EMA by parameter name (None when disabled), the two
    optimizer states (the critic's None without a fake score) and the
    number of iterations taken."""
    student: nn.Module
    teacher: nn.Module
    fake_score: Optional[nn.Module]
    ema: Optional[Dict[str, torch.Tensor]]
    opt_student: OptState
    opt_fake: Optional[OptState]
    step: int = 0

    def state_dict(self) -> Dict:
        """What a checkpoint keeps: all but the frozen teacher."""
        return {"student": self.student.state_dict(),
                "fake_score": (None if self.fake_score is None
                               else self.fake_score.state_dict()),
                "ema": self.ema, "opt_student": self.opt_student.state_dict(),
                "opt_fake": (None if self.opt_fake is None
                             else self.opt_fake.state_dict()),
                "step": int(self.step)}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        self.student.load_state_dict(sd["student"])
        self.opt_student.load_state_dict(sd["opt_student"])
        if self.fake_score is not None:
            self.fake_score.load_state_dict(sd["fake_score"])
            self.opt_fake.load_state_dict(sd["opt_fake"])
        if self.ema is not None:
            for name, t in sd["ema"].items():
                self.ema[name].copy_(t)
        self.step = sd["step"]


def create_distill_state(teacher: nn.Module, optimizer: Optimizer,
                         dcfg: DistillConfig,
                         with_fake: bool = True) -> DistillState:
    """Student and fake score initialised from the teacher, which is frozen
    (distill.py:306-319); the EMA starts at the student in fp32."""
    student = copy.deepcopy(teacher).requires_grad_(True)
    fake = copy.deepcopy(teacher).requires_grad_(True) if with_fake else None
    teacher.requires_grad_(False)
    ema = ({n: p.detach().float().clone()
            for n, p in student.named_parameters()}
           if dcfg.ema_enabled else None)
    return DistillState(student, teacher, fake, ema, optimizer.init(student),
                        optimizer.init(fake) if with_fake else None, 0)


def make_distill_steps(dcfg: DistillConfig, optimizer: Optimizer,
                       with_fake: bool = True, time_phases: bool = False):
    """One outer iteration with the host-side phase dispatch and the power
    EMA (distill.py:322-409): train_step(state, batch, generator) ->
    (state, metrics). Metrics: a student iteration {"loss", "loss_cm",
    "loss_dmd", "grad_norm"}, a critic iteration {"loss_critic",
    "grad_norm"}, each with "student_phase" (1 or 0). Given their draws:
    train_step.student_step(state, batch, cm_draws, dmd, iteration) (dmd
    None without DMD), train_step.critic_step(state, batch, draws),
    train_step.ema_update(state, beta). time_phases (on a card):
    synchronise after each phase and add its ms (student: teacher,
    tangent, student_forward, dmd, backward, optimizer, ema; critic:
    simulation, fake_forward, backward, optimizer)."""
    gamma = power_ema_gamma(dcfg.ema_rate)
    use_dmd = with_fake and dcfg.loss_scale_dmd > 0

    def student_step(state: DistillState, batch: Dict, cm_draws,
                     dmd: Optional[DmdDraws], iteration: int):
        x0 = batch["latents"].float()
        cond = batch["t5_text_embeddings"]
        uncond = batch.get("neg_t5_text_embeddings")
        clock = _PhaseClock(time_phases, x0.device)
        state.student.zero_grad(set_to_none=True)
        if dcfg.cm_type == "dcm":
            l_cm = dcm_loss(state.student, state.teacher, x0, cond, uncond,
                            *cm_draws, dcfg, clock)
        else:
            l_cm = scm_loss(state.student, state.teacher, x0, cond, uncond,
                            *cm_draws, iteration, dcfg, clock)
        l_dmd = torch.zeros((), device=x0.device)
        if use_dmd:
            l_dmd = dmd_loss(state.student, state.teacher, state.fake_score,
                             cond, uncond, dmd, dcfg, clock)
        loss = l_cm + l_dmd
        loss.backward()
        clock.mark("backward")
        metrics = optimizer.update(state.opt_student)
        clock.mark("optimizer")
        state.step += 1
        return state, {"loss": loss.detach(), "loss_cm": l_cm.detach(),
                       "loss_dmd": l_dmd.detach(), **metrics, **clock.times}

    def critic_step(state: DistillState, batch: Dict, draws: DmdDraws):
        clock = _PhaseClock(time_phases, batch["latents"].device)
        state.fake_score.zero_grad(set_to_none=True)
        loss = critic_loss(state.fake_score, state.student,
                           batch["t5_text_embeddings"], draws, dcfg, clock)
        loss.backward()
        clock.mark("backward")
        metrics = optimizer.update(state.opt_fake)
        clock.mark("optimizer")
        state.step += 1
        return state, {"loss_critic": loss.detach(), **metrics, **clock.times}

    @torch.no_grad()
    def ema_update(state: DistillState, beta: float):
        """ema = ema * beta + (1 - beta) * student, in fp32 (:383-388)."""
        names, params = zip(*state.student.named_parameters())
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, beta)
        torch._foreach_add_(ema, [p.float() * (1.0 - beta) for p in params])
        return state

    def train_step(state: DistillState, batch: Dict,
                   generator: Optional[torch.Generator]):
        x0 = batch["latents"]
        it = int(state.step)
        n_sim = simulation_steps(it, dcfg, with_fake)
        if is_student_phase(it, dcfg, with_fake):
            eff = effective_iteration(it, dcfg, with_fake)
            draw = dcm_draws if dcfg.cm_type == "dcm" else scm_draws
            cm = draw(x0, dcfg, generator)
            dmd = (dmd_draws(x0.shape, n_sim, dcfg, generator, x0.device)
                   if use_dmd else None)
            state, metrics = student_step(state, batch, cm, dmd, it)
            if dcfg.ema_enabled:
                clock = _PhaseClock(time_phases, x0.device)
                ema_update(state, ema_beta(eff, gamma,
                                           dcfg.ema_iteration_shift))
                clock.mark("ema")
                metrics.update(clock.times)
            return state, {**metrics, "student_phase": 1.0}
        draws = dmd_draws(x0.shape, n_sim, dcfg, generator, x0.device)
        state, metrics = critic_step(state, batch, draws)
        return state, {**metrics, "student_phase": 0.0}

    train_step.student_step = student_step
    train_step.critic_step = critic_step
    train_step.ema_update = ema_update
    return train_step
