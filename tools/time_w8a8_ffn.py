"""Card time of K10 and K11, the W8A8 FFN GEMMs, at the Wan2.1 FFN shapes.

Usage:
  python tools/time_w8a8_ffn.py [--root DIR] [--label NAME]
      [--models 1.3b,14b] [--rows 32760] [--rounds 5] [--reps 10]

Builds each model's fc1 / fc2 operands as a 480p/81f request feeds them
(32,760 rows of N(0, 1) activations through K8's plain version; weights
N(0, 1/fan_in) through the port's per-channel quantiser; fc2's int8 input
and slab scales from K10's plain version), launches the port's K10 launcher
(`ops.quant._int8_gemm_qout_cuda`: fc1 + bias + GELU -> int8 with per-(row,
BN) scales) and K11 launcher (`_int8_gemm_blockact_cuda`: fc2 over BN-wide K
slabs + bias, gate, residual), checks each against its plain version (int8
within 1 LSB and scales rtol 1e-5; bf16 atol 2e-2 + rtol 2e-2) and prints
one JSON line per (model, kernel): the time a launch takes (CUDA events
around `--reps` launches, `--rounds` rounds: min, median, max), TOP/s, the
share of the 1,979 TOP/s int8 peak, the bound (2 M N K operations at that
peak), `torch._int_mm` on the same int8 operands (the product alone, the
same rounds), the errors, and the card's name and power limit.
`--root DIR` imports the package from the checkout at DIR (another tree
unpacked beside this one), so two trees are timed by one script, in turns,
on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import kernel_timing as kt

PEAK_INT8_OPS = kt.PEAK["int8"]
MODELS = {"1.3b": (1536, 8960), "14b": (5120, 13824)}   # dim, FFN


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--models", default="1.3b,14b")
    p.add_argument("--rows", type=int, default=32760)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    kt.use_root(args.root)

    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt

    card = kt.card("time_w8a8_ffn")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    M = args.rows
    for model in args.models.split(","):
        dim, ffn = MODELS[model]
        bn = qt.pick_bn_div(ffn)
        xq, rs = qt.quantize_rows_int8_plain(randn(M, dim))
        w1, s1 = qt.quantize_int8_postscale(randn(ffn, dim, std=dim ** -0.5))
        w2, s2 = qt.quantize_int8_postscale(randn(dim, ffn, std=ffn ** -0.5))
        b1, b2 = randn(ffn, std=0.1), randn(dim, std=0.1)
        gate = randn(dim, std=0.5).float()
        res = randn(M, dim)
        hq, hs = qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1,
                                                   act="gelu_tanh")
        cases = {
            "K10": (lambda: qt._int8_gemm_qout_cuda(xq, rs, w1, s1, b1, "gelu_tanh"),
                    lambda: (hq, hs), xq, w1),
            "K11": (lambda: qt._int8_gemm_blockact_cuda(hq, hs, w2, s2, b2, None,
                                                        bn, gate, res),
                    lambda: qt.int8_gemm_blockact_plain(hq, hs, w2, s2, b2, bk=bn,
                                                        gate=gate, residual=res),
                    hq, w2),
        }
        for name, (kern, plain, a, w) in cases.items():
            K, N = a.shape[1], w.shape[0]
            ops = 2 * M * N * K
            rec = {"label": args.label, "model": model, "kernel": name,
                   "shape": f"{M}x{N}x{K}", "bn": bn, "card": card}
            try:
                got = kern()
            except Exception as e:
                print(json.dumps({**rec, "error": str(e)[:200]}), flush=True)
                continue
            want = plain()
            torch.cuda.synchronize()
            if name == "K10":
                rec["int8_max_diff"] = int((got[0].int() - want[0].int()).abs().max())
                rec["scale_max_rel_err"] = float(
                    ((got[1] - want[1]).abs() / want[1].abs()).max())
                ok = rec["int8_max_diff"] <= 1 and rec["scale_max_rel_err"] <= 1e-5
            else:
                err = (got.float() - want.float()).abs()
                rec["max_abs_err"] = float(err.max())
                ok = bool((err <= 2e-2 + 2e-2 * want.float().abs()).all())
            rec["ok"] = ok
            del got, want
            ms = kt.times(kern, args.rounds, args.reps)
            lib = kt.times(lambda: torch._int_mm(a, w.t()), args.rounds, args.reps)
            med = statistics.median(ms)
            print(json.dumps({
                **rec, "ms_min": min(ms), "ms_median": med, "ms_max": max(ms),
                "tops": ops / med * 1e-9, "peak_share": ops / med * 1e3 / PEAK_INT8_OPS,
                "bound_ms": ops / PEAK_INT8_OPS * 1e3,
                "int_mm_ms_median": statistics.median(lib),
                "int_mm_tops": ops / statistics.median(lib) * 1e-9}), flush=True)
        del xq, rs, w1, w2, hq, hs, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
