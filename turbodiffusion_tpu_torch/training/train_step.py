"""Training steps: the SLA white-box fine-tune.

Ports `turbodiffusion_tpu/training/train_step.py`: the MSE between the
sparse student's velocity and the frozen dense teacher's at RectifiedFlow-
noised inputs (reference rcm/models/t2v_model_sla.py:300-336), the AdamW
optimizer chain and the LambdaLinear warmup.

The port's state is a module and a torch optimizer where JAX's is a
parameter tree and an optax state: `TrainState.params` is the trained
`WanModel`, updated in place by `Optimizer.update`. The configurations JAX
passes beside its parameter trees live on the modules. Randomness comes
from a `torch.Generator`; the step is split so that the loss given its
draws (`sla_step_loss(..., rf_t, eps)`) and the update given them
(`train_step.apply`) are functions of their own, which the tests feed the
draws JAX makes from its key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from turbodiffusion_tpu_torch.training.timesteps import LogNormal


@dataclasses.dataclass
class TrainState:
    """JAX's TrainState(params, opt_state, step): the model being trained,
    its optimizer state and the number of steps taken."""
    params: nn.Module
    opt_state: "OptState"
    step: int = 0

    def state_dict(self) -> Dict:
        """What a checkpoint keeps."""
        return {"model": self.params.state_dict(),
                "optimizer": self.opt_state.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: Dict) -> None:
        self.params.load_state_dict(sd["model"])
        self.opt_state.load_state_dict(sd["optimizer"])
        self.step = sd["step"]


def lambda_linear_schedule(base_lr: float, warmup_steps: int = 1000,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0) -> Callable[[int], float]:
    """LambdaLinearScheduler (rcm/utils/lr_scheduler.py): linear warmup from
    f_start to f_max over warmup_steps, then a constant f_min multiplier.
    Returns the learning rate at a step."""
    def schedule(step: int) -> float:
        frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        mult = f_start + (f_max - f_start) * frac if step < warmup_steps \
            else f_min
        return base_lr * mult
    return schedule


@dataclasses.dataclass
class OptState:
    """A model's optimizer state: torch AdamW over its trainable parameters
    (moments in each parameter's dtype, as optax keeps them), the warmup
    schedule (None without one) and the parameters in order."""
    adamw: torch.optim.AdamW
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    params: List[nn.Parameter]

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": (self.scheduler.state_dict()
                              if self.scheduler is not None else None)}

    def load_state_dict(self, sd: Dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """JAX's optax chain (train_step.py:40-55), in its order: the gradients'
    NaN and infinities set to 0, `clip_by_global_norm(grad_clip)` when
    grad_clip > 0, then AdamW (b1 0.9, b2 0.95, weight decay 1e-4, eps
    1e-8) at the learning rate of `lambda_linear_schedule` when
    warmup_steps > 0. The equivalent of the reference's FusedAdam and its
    GradClip callback (rcm/callbacks/grad_clip.py:27-61)."""
    lr: float = 1e-5
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 0
    grad_clip: float = 0.0
    force_finite: bool = True

    def init(self, model: nn.Module) -> OptState:
        params = [p for p in model.parameters() if p.requires_grad]
        adamw = torch.optim.AdamW(params, lr=self.lr, betas=(self.b1, self.b2),
                                  eps=self.eps, weight_decay=self.weight_decay)
        sched = None
        if self.warmup_steps:
            lr_at = lambda_linear_schedule(self.lr, self.warmup_steps)
            sched = torch.optim.lr_scheduler.LambdaLR(
                adamw, lambda step: lr_at(step) / self.lr)
        return OptState(adamw, sched, params)

    @torch.no_grad()
    def update(self, opt_state: OptState) -> Dict[str, torch.Tensor]:
        """Apply the chain to the parameters' .grad and step AdamW in place.
        A parameter without a gradient takes a zero one, as every optax
        leaf gets an update. Returns {"grad_norm"}: the global norm after
        the NaN filter, before clipping."""
        grads = []
        for p in opt_state.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.force_finite:
            for g in grads:
                torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if self.grad_clip > 0:
            # optax: g * max_norm / g_norm where g_norm >= max_norm
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        opt_state.adamw.step()
        if opt_state.scheduler is not None:
            opt_state.scheduler.step()
        return {"grad_norm": norm}


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-4,
                   b1: float = 0.9, b2: float = 0.95,
                   warmup_steps: int = 0, grad_clip: float = 0.0,
                   force_finite: bool = True) -> Optimizer:
    """The optimizer chain; `.init(model)` makes its state
    (train_step.py:40-55)."""
    return Optimizer(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2,
                     warmup_steps=warmup_steps, grad_clip=grad_clip,
                     force_finite=force_finite)


def sla_draws(x0, generator: Optional[torch.Generator], p_mean: float = 0.0,
              p_std: float = 1.6):
    """The step's random draws: RF times (B, 1) ~ LogNormal(p_mean, p_std)
    in the RF domain, and the noise, shaped like x0, in fp32."""
    rf_t = LogNormal(p_mean, p_std)(generator, (x0.shape[0], 1), x0.device)
    eps = torch.randn(x0.shape, generator=generator, device=x0.device)
    return rf_t, eps


class _PhaseClock:
    """Host times of a step's phases, each ended by a device synchronise;
    off, it records nothing and synchronises nothing."""

    def __init__(self, on: bool = False, device="cpu"):
        self.on = on and torch.device(device).type == "cuda"
        self.times: Dict[str, float] = {}
        self._t = time.perf_counter() if self.on else 0.0

    def mark(self, name: str) -> None:
        if self.on:
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.times[f"{name}_ms"] = (now - self._t) * 1e3
            self._t = now


def sla_step_loss(student: nn.Module, teacher: nn.Module, x0, emb, rf_t, eps,
                  loss_scale: float = 1.0, t_scaling: float = 1000.0,
                  clock: Optional[_PhaseClock] = None):
    """The SLA fine-tune loss given its draws (train_step.py:75-92): the
    latents noised at RF time rf_t, the frozen teacher's velocity (no
    gradient), the student's, loss_scale * mean((v - v_teacher)^2)."""
    clock = clock or _PhaseClock()
    t5 = rf_t[:, :, None, None, None]
    xt = (1.0 - t5) * x0.float() + t5 * eps
    tt = (rf_t * t_scaling).float()
    with torch.no_grad():
        v_teacher = teacher(xt, tt, emb).float()
    clock.mark("teacher")
    v = student(xt, tt, emb).float()
    loss = loss_scale * torch.mean((v - v_teacher) ** 2)
    clock.mark("forward")
    return loss


def make_sla_train_step(teacher: nn.Module, optimizer: Optimizer,
                        loss_scale: float = 1.0, p_mean: float = 0.0,
                        p_std: float = 1.6, t_scaling: float = 1000.0,
                        time_phases: bool = False):
    """White-box SLA fine-tuning as t2v_model_sla.py:300-336
    (train_step.py:58-96): draw RF time ~ LogNormal, noise the latents,
    regress the sparse student's velocity onto the frozen dense teacher's.
    Returns train_step(state, batch, generator) -> (state, metrics) with
    metrics {"loss", "grad_norm"}; train_step.apply(state, batch, rf_t, eps)
    takes the draws as given. time_phases (on a card): synchronise after
    each phase and add teacher / forward / backward / optimizer ms."""
    teacher.requires_grad_(False)

    def apply(state: TrainState, batch: Dict, rf_t, eps):
        model = state.params
        x0 = batch["latents"]
        clock = _PhaseClock(time_phases, x0.device)
        model.zero_grad(set_to_none=True)
        loss = sla_step_loss(model, teacher, x0, batch["t5_text_embeddings"],
                             rf_t, eps, loss_scale, t_scaling, clock)
        loss.backward()
        clock.mark("backward")
        metrics = optimizer.update(state.opt_state)
        clock.mark("optimizer")
        state.step += 1
        return state, {"loss": loss.detach(), **metrics, **clock.times}

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator]):
        rf_t, eps = sla_draws(batch["latents"], generator, p_mean, p_std)
        return apply(state, batch, rf_t, eps)

    train_step.apply = apply
    return train_step


def sla_finetune_loss(model: nn.Module, batch: Dict):
    """White-box SLA loss against a given teacher velocity
    (train_step.py:99-109): batch {'latents', 'teacher_velocity',
    't5_text_embeddings', 'timesteps' (B, 1) in [0, 1000]}."""
    v_pred = model(batch["latents"], batch["timesteps"],
                   batch["t5_text_embeddings"]).float()
    target = batch["teacher_velocity"].float()
    return torch.mean((v_pred - target) ** 2)


def make_train_step(optimizer: Optimizer):
    """One optimizer step on `sla_finetune_loss` (train_step.py:112-128);
    the generator is unused, as JAX's key is."""
    def train_step(state: TrainState, batch: Dict, generator=None):
        model = state.params
        model.zero_grad(set_to_none=True)
        loss = sla_finetune_loss(model, batch)
        loss.backward()
        metrics = optimizer.update(state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), **metrics}
    return train_step

