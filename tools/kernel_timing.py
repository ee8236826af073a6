"""What the kernel timing scripts of `tools/` share: the card's peak rates,
the package import from a checkout (`--root`), the card's name and power
limit, CUDA-event times and the profiler's device times.

The scripts run as `python tools/<script>.py`, so this module is found
beside them. Nothing here imports torch before a function is called.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

PEAK = {"int8": 1979e12, "bf16": 989e12}   # H100 SXM dense, NVIDIA's data sheet
HBM = 3.35e12                               # H100 SXM HBM3, bytes/s
ROOT = Path(__file__).resolve().parents[1]


def use_root(root) -> None:
    """Import turbodiffusion_tpu_torch from the checkout at `root` (this
    one when None): another tree unpacked beside this one is then timed by
    the same script, in turns, on one card."""
    sys.path.insert(0, str(root) if root else str(ROOT))


def card(script: str) -> str:
    """The card's name and power limit as nvidia-smi prints them; ends the
    process without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: needs a CUDA card")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def sync(seconds: float = 60.0) -> None:
    """Wait for the card; end the process if it has not finished in time."""
    import torch
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.monotonic()
    while not ev.query():
        if time.monotonic() - t0 > seconds:
            print(json.dumps({"error": f"a launch ran past {seconds} s"}), flush=True)
            os._exit(3)
        time.sleep(0.005)


def times(fn, rounds: int, reps: int) -> list:
    """ms a call of fn takes by CUDA events around `reps` calls, for each of
    `rounds` rounds, after one call that is not timed."""
    import torch
    fn()
    out = []
    for _ in range(rounds):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return out


def device_ms(fn, reps: int, keys: tuple = ("",)) -> float:
    """Device time (ms) a call of fn spends in the kernels whose name holds
    one of `keys` (every kernel for ("",)), over `reps` calls, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and any(k in e.name for k in keys)]
    return sum(us) * 1e-3 / reps if us else float("nan")


def within(got, want, atol: float, rtol: float) -> dict:
    """The largest difference, and whether every element of got is finite
    and within atol + rtol |want|."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()
              and got.float().isfinite().all())
    return {"max_abs_err": float(err.max()), "ok": ok}
