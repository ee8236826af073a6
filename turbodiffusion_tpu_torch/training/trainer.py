"""Training loop with callbacks, checkpointing and a watchdog.

Ports `turbodiffusion_tpu/training/trainer.py` (ImaginaireTrainer,
imaginaire/trainer.py:42-233): a loop without gradient accumulation, a
per-step callback fan-out, periodic checkpoints, resume from the latest, and
the optional SIGALRM stall watchdog (imaginaire/trainer.py:132). A
`torch.Generator` takes the place of JAX's key: the train step draws from
it, and the checkpoints carry its state.
"""

from __future__ import annotations

import json
import logging
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

log = logging.getLogger("turbodiffusion_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s|%(levelname)s|%(message)s", "%H:%M:%S"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


def _scalars(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class Callback:
    """Hook surface of imaginaire's CallBackGroup (utils/callback.py:45-101)."""

    def on_train_start(self, state): ...
    def on_training_step_start(self, state, iteration: int): ...
    def on_training_step_end(self, state, metrics: Dict, iteration: int): ...
    def on_save_checkpoint(self, state, iteration: int): ...
    def on_train_end(self, state): ...


class IterSpeed(Callback):
    """rcm/callbacks/iter_speed.py: rolling it/s and the metrics, logged
    every `every_n` iterations."""

    def __init__(self, every_n: int = 10):
        self.every_n = every_n
        self.t0 = None

    def on_training_step_end(self, state, metrics, iteration):
        if self.t0 is None:
            self.t0 = time.perf_counter()
            return
        if iteration % self.every_n == 0:
            dt = (time.perf_counter() - self.t0) / self.every_n
            self.t0 = time.perf_counter()
            log.info(f"iter {iteration} | {1.0 / dt:.2f} it/s | " +
                     " ".join(f"{k}={v:.4f}"
                              for k, v in _scalars(metrics).items()))


class JsonlLogger(Callback):
    """Metrics sink, one JSON line per iteration (wandb_log.py's place)."""

    def __init__(self, path: str):
        self.path = path

    def on_training_step_end(self, state, metrics, iteration):
        with open(self.path, "a") as f:
            f.write(json.dumps({"iteration": iteration,
                                **_scalars(metrics)}) + "\n")


class HeartBeat(Callback):
    """Touches a liveness file every `every_secs` seconds for external
    monitors (rcm/callbacks/heart_beat.py:29-106)."""

    def __init__(self, path: str, every_secs: float = 60.0):
        self.path = path
        self.every_secs = every_secs
        self._last = 0.0

    def on_training_step_end(self, state, metrics, iteration):
        now = time.time()
        if now - self._last >= self.every_secs:
            with open(self.path, "w") as f:
                f.write(f"{iteration} {now}\n")
            self._last = now


class GradNormMonitor(Callback):
    """Per-step gradient-norm record (rcm/callbacks/grad_clip.py:55)."""

    def __init__(self):
        self.history = []

    def on_training_step_end(self, state, metrics, iteration):
        if "grad_norm" in metrics:
            self.history.append(float(metrics["grad_norm"]))


class DeviceMonitor(Callback):
    """Periodic per-device memory report (rcm/callbacks/device_monitor.py):
    each card's bytes in use, peak and total from `torch.cuda.memory_stats`
    (the JAX port's `memory_stats()`), and the host's resident set from
    /proc. Without a card it lists the CPU with no memory figures."""

    def __init__(self, every_n: int = 50):
        self.every_n = every_n
        self.last: Dict = {}

    @staticmethod
    def snapshot() -> Dict:
        report: Dict = {"devices": []}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                report["devices"].append({
                    "id": i, "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory)})
        else:
            report["devices"].append({"id": 0, "kind": "cpu"})
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        report["host_rss_kb"] = int(line.split()[1])
                        break
        except OSError:
            pass
        return report

    def on_training_step_end(self, state, metrics, iteration):
        if iteration % self.every_n:
            return
        self.last = self.snapshot()
        parts = []
        for d in self.last["devices"]:
            if "bytes_in_use" in d:
                lim = d.get("bytes_limit") or 1
                parts.append(
                    f"d{d['id']} {d['bytes_in_use'] / 2**30:.2f}/"
                    f"{lim / 2**30:.2f}GiB "
                    f"(peak {d['peak_bytes_in_use'] / 2**30:.2f})")
        rss = self.last.get("host_rss_kb", 0) / 2**20
        log.info(f"iter {iteration} device mem: "
                 f"{'; '.join(parts) or 'n/a'}; host rss {rss:.2f}GiB")
        metrics["device_bytes_in_use"] = max(
            (d.get("bytes_in_use", 0) for d in self.last["devices"]),
            default=0)


class EveryNDrawSample(Callback):
    """Every `every_n` iterations, draw a sample with the current weights
    (and the EMA weights, where the state tracks them) through draw_fn
    (rcm/callbacks/every_n_draw_distill.py:102, every_n_draw_sla.py:90).
    A failure is logged, never raised: sampling must not stop training."""

    def __init__(self, every_n: int, draw_fn, out_dir: str = "samples"):
        """draw_fn(model, tag, iteration) -> path of the saved sample."""
        self.every_n = every_n
        self.draw_fn = draw_fn
        self.out_dir = out_dir

    def on_training_step_end(self, state, metrics, iteration):
        if iteration == 0 or iteration % self.every_n:
            return
        params = getattr(state, "student", None)
        if params is None:
            params = getattr(state, "params", None)
        try:
            if params is None:
                raise AttributeError(
                    f"state {type(state).__name__} has neither .student "
                    "nor .params")
            self.draw_fn(params, "reg", iteration)
            ema = getattr(state, "ema", None)
            if ema is not None:
                self.draw_fn(ema, "ema", iteration)
        except Exception as e:  # sampling must never kill training
            log.warning(f"EveryNDrawSample failed at iter {iteration}: {e}")


@dataclass
class TrainerConfig:
    max_iter: int = 1000
    save_every: int = 500
    watchdog_secs: int = 0       # 0 disables (trainer.py:132 SIGALRM)
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 checkpointer=None, callbacks: Optional[List[Callback]] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.checkpointer = checkpointer
        self.callbacks = callbacks or [IterSpeed(cfg.log_every)]

    def _fan(self, hook: str, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(*args)

    def train(self, state, dataloader, generator: Optional[torch.Generator],
              start_iter: int = 0):
        if self.cfg.watchdog_secs:
            def _timeout(signum, frame):
                raise TimeoutError(
                    f"no training step completed within "
                    f"{self.cfg.watchdog_secs}s (watchdog)")
            signal.signal(signal.SIGALRM, _timeout)

        self._fan("on_train_start", state)
        it = saved = start_iter
        data_iter = iter(dataloader)
        while it < self.cfg.max_iter:
            if self.cfg.watchdog_secs:
                signal.alarm(self.cfg.watchdog_secs)
            self._fan("on_training_step_start", state, it)
            batch = next(data_iter)
            state, metrics = self.train_step(state, batch, generator)
            self._fan("on_training_step_end", state, metrics, it)
            it += 1
            if self.checkpointer and it % self.cfg.save_every == 0:
                self.checkpointer.save(it, state, generator)
                saved = it
                self._fan("on_save_checkpoint", state, it)
        if self.cfg.watchdog_secs:
            signal.alarm(0)
        if self.checkpointer:
            if saved != it:
                self.checkpointer.save(it, state, generator)
            self.checkpointer.wait()
        self._fan("on_train_end", state)
        return state
