"""Card time of K2 (`rmsnorm_rope`'s CUDA kernel) by row width.

Usage:
  python tools/time_k2.py [--root DIR] [--label NAME] [--rows 32760]
      [--widths 12x128,40x128,48x128] [--rounds 7] [--reps 20]

Launches the port's K2 launcher (`ops.fused_norm._rmsrope_cuda`) on
seeded random bf16 rows of H x Dh channels, with the rotate-half RoPE
tables of the rows and without them (norm only), and prints one JSON line
per (width, mode): the time a launch takes (CUDA events around `--reps`
launches, `--rounds` rounds: min, median, max), the bound (each input read
once, the output written once, at 3.35 TB/s), the largest difference from
K2's plain version on the same inputs, and the card's name and power
limit. A width the launcher refuses prints its error instead.
`--root DIR` imports the package from the checkout at DIR (another tree
unpacked beside this one), so two kernels are timed by one script, in
turns, on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--rows", type=int, default=32760)
    p.add_argument("--widths", default="12x128,40x128,48x128")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[1]))

    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn

    if not torch.cuda.is_available():
        raise SystemExit("time_k2: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    for spec in args.widths.split(","):
        H, Dh = (int(v) for v in spec.split("x"))
        HD = H * Dh
        x = torch.randn((1, args.rows, HD), generator=g, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(HD, generator=g, device="cuda")).bfloat16()
        ang = torch.rand((args.rows, Dh // 2), generator=g, device="cuda") * 6.28
        tables = fn.rope_cos_sin_full(ang)
        for mode, (cos, sin) in (("rope", tables), ("norm", (None, None))):
            rec = {"label": args.label, "width": spec, "mode": mode,
                   "rows": args.rows, "card": card}
            try:
                got = fn._rmsrope_cuda(x, w, cos, sin, 1e-6, H)
            except Exception as e:         # an older tree's width guard
                print(json.dumps({**rec, "refused": str(e)[:120]}), flush=True)
                continue
            want = fn._rmsrope_plain(x, w, cos, sin, 1e-6, H)
            rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
            del got, want
            ms = []
            for _ in range(args.rounds):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(args.reps):
                    fn._rmsrope_cuda(x, w, cos, sin, 1e-6, H)
                t1.record()
                t1.synchronize()
                ms.append(t0.elapsed_time(t1) / args.reps)
            nbytes = 2 * x.numel() * 2 + HD * 2 + (
                0 if cos is None else 2 * cos.numel() * 4)
            print(json.dumps({**rec, "ms_min": min(ms),
                              "ms_median": statistics.median(ms),
                              "ms_max": max(ms),
                              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
