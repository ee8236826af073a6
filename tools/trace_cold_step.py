"""Trace the cold one-step SLA training runs of chip_smoke phase 5.

Usage:
  python tools/trace_cold_step.py [--root DIR] [--label NAME] [--rounds 2]

Writes phase 5's 1.3B teacher checkpoint and 480p shards (chip_smoke's
`_training_data`), takes one untraced `--remat block_wise` step at 81
frames (as phase 5's first run warms the process), then `--rounds` times
the two one-step 21-frame runs of phase 5 (`--remat none`, and the same
with `-- model.attention.backend=sagesla`), each a fresh
`scripts.train.main` as phase 5 runs it, its step under torch.profiler
(host and device). One JSON line per run: the step's wall time and phase
split (`--time_phases`), the device window and idle share and the kernel
time by category (chip_smoke's `_profile_summary`), the three longest
device gaps (start in ms from the first kernel, length), the host calls
with the most self time (CUDA runtime calls included: cudaMalloc,
cudaFree, synchronisations), the caching allocator's new segments and
retries in the step, and the card's name and power limit. A slow step then
shows where it waits: in a kernel category, on the host between kernels,
or in the allocator. `--root DIR` imports the package from the checkout
at DIR (chip_smoke from this one), so two trees are traced in turns on one
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import kernel_timing as kt


def _gaps(prof, n: int = 3) -> list:
    """The n longest gaps between the device's busy intervals: [start ms
    from the first kernel, length ms]."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return []
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a > end:
            gaps.append((a - end, end - spans[0][0]))
        end = max(end, b)
    return [[round(at * 1e-3, 3), round(g * 1e-3, 3)] for g, at in sorted(gaps)[-n:][::-1]]


def _host_top(prof, n: int = 6) -> list:
    """The host calls with the most self time: [name, ms, calls]."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    rows.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    return [[e.key, round(e.self_cpu_time_total * 1e-3, 3), e.count] for e in rows[:n]]


def _probe(label: str, base: dict, trace: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from turbodiffusion_tpu_torch.training.trainer import Callback

    import chip_smoke

    class Probe(Callback):
        def on_training_step_start(self, state, it):
            torch.cuda.synchronize()
            self.stats = torch.cuda.memory_stats()
            self.prof = None
            if trace:
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
            self.t0 = time.perf_counter()

        def on_training_step_end(self, state, metrics, it):
            torch.cuda.synchronize()
            wall = (time.perf_counter() - self.t0) * 1e3
            after = torch.cuda.memory_stats()
            rec = {**base, "run": label, "step": it, "wall_ms": wall,
                   **{k: float(v) for k, v in metrics.items() if k.endswith("_ms")},
                   "new_segments": after.get("segment.all.allocated", 0)
                   - self.stats.get("segment.all.allocated", 0),
                   "alloc_retries": after.get("num_alloc_retries", 0)
                   - self.stats.get("num_alloc_retries", 0)}
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
                rec.update(profile=chip_smoke._profile_summary(self.prof),
                           device_gaps_ms=_gaps(self.prof),
                           host_top_ms=_host_top(self.prof))
            print(json.dumps(rec), flush=True)

    return Probe()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    kt.use_root(args.root)
    sys.path.insert(1, str(kt.ROOT))            # chip_smoke from this tree

    import gc

    import torch

    import chip_smoke
    from turbodiffusion_tpu_torch.ops._build import BUILD_DIR
    from turbodiffusion_tpu_torch.scripts import train

    base = {"label": args.label, "card": kt.card("trace_cold_step")}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ckpt, shards = chip_smoke._training_data(tmp)
        common = ["--experiment", "sla", "--model", chip_smoke.G13.model,
                  "--teacher_ckpt", ckpt, "--seed", "0", "--lr", "1e-5",
                  "--max_iter", "1", "--ckpt_dir", "", "--time_phases"]
        runs = [("block_wise 81f", 81, "block_wise", [], False)]
        for _ in range(args.rounds):
            runs += [("none 21f", 21, "none", [], True),
                     ("sagesla none 21f", 21, "none",
                      ["model.attention.backend=sagesla"], True)]
        for label, frames, remat, ovr, trace in runs:
            train.main(common + ["--data", shards[frames], "--remat", remat, "--",
                                 "trainer.log_every=1", *ovr],
                       callbacks=[_probe(label, base, trace)])
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
