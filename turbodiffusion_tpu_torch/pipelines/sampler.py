"""rCM consistency sampling (TrigFlow -> RectifiedFlow).

Ports `turbodiffusion_tpu/pipelines/sampler.py:23-77`. The schedule stays a
float64 numpy computation. The fresh noise of each SDE step comes from a
`torch.Generator` on the latent's device, or is given as tensors (the tests
hand both packages the same draws: `jax.random` cannot be reproduced in
torch).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from turbodiffusion_tpu_torch.config import GenerationConfig


def rcm_timesteps(num_steps: int, sigma_max: float,
                  mid_t: Sequence[float] = (1.5, 1.4, 1.0)) -> np.ndarray:
    """t = [atan(sigma_max), *mid_t, 0] -> sin(t) / (cos(t) + sin(t)),
    computed in float64, returned as float32 (sampler.py:23-33)."""
    ts = np.asarray([math.atan(sigma_max), *list(mid_t)[: num_steps - 1], 0.0],
                    np.float64)
    ts = np.sin(ts) / (np.cos(ts) + np.sin(ts))
    return ts.astype(np.float32)


def rcm_sample(denoise_fn: Callable, init_noise: torch.Tensor,
               num_steps: int = 4, sigma_max: float = 80.0,
               mid_t: Sequence[float] = (1.5, 1.4, 1.0), ode: bool = False,
               generator: Optional[torch.Generator] = None,
               step_noises: Optional[Sequence[torch.Tensor]] = None):
    """Run the 1-4 step rCM sampler (sampler.py:36-65).

    denoise_fn(x, t_scalar, step_index) -> velocity. init_noise: (B, C, T, H,
    W) standard normal. SDE steps draw fresh noise from `generator` unless
    `step_noises` gives it, then take
        x <- (1 - t_next) * (x - t_cur * v) + t_next * noise;
    ODE steps take x <- x - (t_cur - t_next) * v. The scalars are computed
    in float32, as in JAX.
    """
    t_steps = rcm_timesteps(num_steps, sigma_max, mid_t)
    x = init_noise.float() * float(t_steps[0])
    for i in range(num_steps):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        v = denoise_fn(x, t_cur, i).float()
        if ode:
            x = x - float(np.float32(t_cur) - np.float32(t_next)) * v
            continue
        if step_noises is not None:
            noise = step_noises[i].to(x.device, torch.float32)
        else:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=torch.float32)
        x = (float(np.float32(1.0) - t_next) * (x - float(t_cur) * v)
             + float(t_next) * noise)
    return x


def latent_shape(gen: GenerationConfig, latent_ch: int = 16,
                 spatial_factor: int = 8, temporal_factor: int = 4,
                 width: Optional[int] = None, height: Optional[int] = None):
    """(C, T_lat, H_lat, W_lat) of a request (sampler.py:68-77)."""
    from turbodiffusion_tpu_torch.config import VIDEO_RES_SIZE_INFO
    if width is None or height is None:
        width, height = VIDEO_RES_SIZE_INFO[gen.resolution][gen.aspect_ratio]
    t_lat = 1 + (gen.num_frames - 1) // temporal_factor
    return (latent_ch, t_lat, height // spatial_factor, width // spatial_factor)
