"""Timestep domain conversions and training-time samplers.

Ports `turbodiffusion_tpu/training/timesteps.py` (behavioural reference:
rcm/utils/timestep_utils.py and rcm/utils/denoiser_scaling.py:19-30). The
samplers draw from a `torch.Generator` where JAX takes a key; the two give
different numbers from one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def shift_rf_time(u, shift: float):
    """shift*u / (1 + (shift-1)*u) (timestep_utils.py:5-8)."""
    if shift <= 0:
        return u
    return shift * u / (1 + (shift - 1) * u)


def sigma_to_rf_time(sigma):
    return sigma / (sigma + 1)


def rf_to_sigma(rf_t):
    rf_t = torch.clamp(rf_t, 0.0, 1.0 - torch.finfo(torch.float32).eps)
    return rf_t / (1 - rf_t)


def sigma_to_trig_time(sigma):
    return torch.arctan(sigma)


def trig_to_sigma(trig_t):
    return torch.tan(trig_t)


def rf_to_trig_time(rf_t):
    return sigma_to_trig_time(rf_to_sigma(rf_t))


def trig_to_rf_time(trig_t):
    return sigma_to_rf_time(trig_to_sigma(trig_t))


@dataclasses.dataclass(frozen=True)
class LogNormal:
    """Log-normal sigma sampler returning RF-domain time
    (timestep_utils.py:48-63)."""
    p_mean: float = 0.0
    p_std: float = 1.0

    def __call__(self, generator: Optional[torch.Generator], shape,
                 device=None):
        device = device if device is not None else (
            generator.device if generator is not None else None)
        log_sigma = (torch.randn(shape, generator=generator, device=device)
                     * self.p_std + self.p_mean)
        return torch.clamp(sigma_to_rf_time(torch.exp(log_sigma)), 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class UniformShift:
    """Uniform RF time with shift (timestep_utils.py:66-78)."""
    shift: float = 0.0

    def __call__(self, generator: Optional[torch.Generator], shape,
                 device=None):
        device = device if device is not None else (
            generator.device if generator is not None else None)
        u = torch.rand(shape, generator=generator, device=device)
        return torch.clamp(shift_rf_time(u, self.shift), 0.0, 1.0)


def trigflow_scaling(trig_t, t_scaling_factor: float = 1000.0
                     ) -> Tuple[torch.Tensor, ...]:
    """RectifiedFlow_TrigFlowWrapper (denoiser_scaling.py:19-30):
    (c_skip, c_out, c_in, c_noise) for a TrigFlow time on an RF-trained net."""
    denom = torch.cos(trig_t) + torch.sin(trig_t)
    c_skip = 1.0 / denom
    c_out = -torch.sin(trig_t) / denom
    c_in = 1.0 / denom
    c_noise = (torch.sin(trig_t) / denom) * t_scaling_factor
    return c_skip, c_out, c_in, c_noise


def power_ema_gamma(rate: float) -> float:
    """Karras power-function EMA exponent (t2v_model_distill_rcm.py:272)."""
    return float(np.roots([1, 7, 16 - rate ** -2, 12 - rate ** -2]).real.max())


def ema_beta(iteration: int, gamma: float, iteration_shift: int = 0) -> float:
    """(1 - 1/(i+1))^(gamma+1) (t2v_model_distill_rcm.py:1048-1062)."""
    iteration = iteration + iteration_shift
    if iteration < 1:
        return 0.0
    return (1 - 1 / (iteration + 1)) ** (gamma + 1)
