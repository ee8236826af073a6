"""Where the linear branch's kv sums round: K6's and K21's arithmetic
emulated on the CPU at the 480p length (32,760 rows a head), against
float64 sums. No card: plain torch, seeded generators.

Usage:
  python tools/kv_rounding.py k6 [--heads 40] [--run 24]
  python tools/kv_rounding.py tc [--heads 3]
  python tools/kv_rounding.py k21 [--frag 64] [--model exact|tc0|tc2|tc3]
  python tools/kv_rounding.py phi32 [--heads 8] [--kstd 2]

  * k6: K6's kv (csrc/sla_fused.cu k6::pack_kvt_kernel) on K of N(0, 1) and
    uniform int8 V, as `tools/time_k6_k16.py` draws them: each 32-row step's
    products of fp16 hi / lo of 2^8 phi against V summed exactly and rounded
    once to fp32, the steps summed in fp32 over K6's runs (`sf.kvt_grid` on
    132 SMs, runs of at most `--run` K blocks), the runs' partials added in
    run order. For plain fp32 step sums (K6's) and Kahan-compensated ones:
    the worst element's |err| over rtol / atol 1e-4 of the float64 sums,
    its largest over the heads and the heads' mean, and the mean |err|.
  * tc: the same steps on 128 channels of `--heads` heads with models of
    the tensor core's own sum in each wgmma, tcN: the k = 16 products and the
    accumulator aligned to the largest, each cut below 2^-N of that one's
    last bit (2^-(23 + N) of it), the sum cut to 24 bits (round toward
    zero); `tools/time_k21.py --probe` reads N = 2 on an H100. Against exact
    step sums (`exact`).
  * k21: K21's kv pass (csrc/linear_attention.cu k21::kv_kernel) on one
    head of uniform int8-valued bf16 V: phi as three exact bf16 parts,
    fragments of `--frag` rows under the tensor-core model `--model`,
    plain fp32 sums of zeroed fragments, or Kahan sums whose fragment
    starts at minus the compensation (the kernel's), runs of 9,920 rows
    (40 heads on 132 blocks).
  * phi32: the floor fp32 phi sets on chip_smoke's 40-head K21 input kind
    (k of std `--kstd`, V of 50 N(0, 1) rounded and clamped to +-127, in
    bf16): float64 sums of phi = softmax_D(k) taken in fp32 (torch's),
    against the float64 sums of float64 phi, as the worst element over
    rtol / atol 1e-4 over `--heads` heads.
Each prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
L, LP, DH, BK = 32760, 32768, 128, 256


def _trunc(x, q):
    import torch
    return torch.sign(x) * torch.floor(x.abs() / q) * q


def _tc_instr(c, a, b, extra):
    """c + a^T b over k <= 16 rows: products exact, aligned to the largest
    of them and c, each cut below 2^-(24 + extra) of it, the exact sum cut
    to 24 bits (round toward zero)."""
    import torch
    terms = torch.cat([c[None], a[:, :, None] * b[:, None, :]], 0)
    _, e = torch.frexp(terms.abs().amax(0))
    s = _trunc(terms, torch.ldexp(torch.ones_like(c), e - 24 - extra)[None]).sum(0)
    _, e = torch.frexp(s)
    return _trunc(s, torch.ldexp(torch.ones_like(s), e - 24))


def _ratio(got, exact):
    err = (got.double() - exact).abs()
    return float((err / (1e-4 + 1e-4 * exact.abs())).max()), float(err.mean())


def _k6_steps(k, v):
    """K6's step fragments (fp32, exact sums of the hi and lo products) and
    the float64 kv of one head."""
    import torch
    valid = (torch.arange(LP) < L)[:, None]
    s = torch.where(valid, torch.softmax(k.float(), -1), 0.0) * 256
    hi = s.half().float()
    lo = (s - hi).half().float()
    vd = v.double().reshape(-1, 32, DH)
    steps = (torch.einsum("src,srd->scd", hi.double().reshape(-1, 32, DH), vd)
             + torch.einsum("src,srd->scd", lo.double().reshape(-1, 32, DH), vd))
    exact = torch.where(valid, torch.softmax(k.double(), -1), 0.0).t() @ v.double()
    return steps.float(), hi, lo, exact


def k6(args) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    nK = LP // BK
    sf._KVT_MAX_RUN = args.run
    grid = sf.kvt_grid(1, args.heads, LP, BK, 132, True)
    runs = sf.kvt_runs(args.heads * nK, grid)
    g = torch.Generator().manual_seed(args.heads)
    out = {"heads": args.heads, "run": args.run, "grid": grid}
    worst = {"plain": [], "kahan": []}
    mean = {"plain": [], "kahan": []}
    for h in range(args.heads):
        k = torch.randn((LP, DH), generator=g).bfloat16()
        k[L:] = 0
        v = torch.randint(-127, 128, (LP, DH), generator=g, dtype=torch.int8)
        v[L:] = 0
        steps, _, _, exact = _k6_steps(k, v)
        for mode in worst:
            tot = torch.zeros(DH, DH)
            for a, e in runs:
                b0, b1 = max(a, h * nK), min(e, (h + 1) * nK)
                if b0 >= b1:
                    continue
                acc, comp = torch.zeros(DH, DH), torch.zeros(DH, DH)
                for st in range((b0 - h * nK) * BK // 32, (b1 - h * nK) * BK // 32):
                    y = steps[st] - comp if mode == "kahan" else steps[st]
                    t = acc + y
                    if mode == "kahan":
                        comp = (t - acc) - y
                    acc = t
                tot = tot + (acc - comp) / 256
            r, m = _ratio(tot, exact)
            worst[mode].append(r)
            mean[mode].append(m)
    for mode in worst:
        out[mode] = {"worst_ratio_max": max(worst[mode]),
                     "worst_ratio_mean": float(np.mean(worst[mode])),
                     "mean_abs_err": float(np.mean(mean[mode]))}
    return out


def tc(args) -> dict:
    import torch
    g = torch.Generator().manual_seed(7)
    runs = 8 * 19                                   # steps of a run: ~19 K blocks
    out = {"heads": args.heads, "steps_per_run": runs}
    for h in range(args.heads):
        k = torch.randn((LP, DH), generator=g).bfloat16()
        k[L:] = 0
        v = torch.randint(-127, 128, (LP, DH), generator=g, dtype=torch.int8)
        v[L:] = 0
        steps, hi, lo, exact = _k6_steps(k, v)
        hi, lo, vd = hi.double(), lo.double(), v.double()
        for mode in ("exact", "tc0", "tc2", "tc3"):
            tot, acc = torch.zeros(DH, DH), torch.zeros(DH, DH)
            for st in range(LP // 32):
                if mode == "exact":
                    frag = steps[st]
                else:
                    f = torch.zeros(DH, DH, dtype=torch.float64)
                    for ks in range(2):
                        sl = slice(32 * st + 16 * ks, 32 * st + 16 * ks + 16)
                        f = _tc_instr(f, hi[sl], vd[sl], int(mode[2:]))
                        f = _tc_instr(f, lo[sl], vd[sl], int(mode[2:]))
                    frag = f.float()
                acc = acc + frag
                if (st + 1) % runs == 0:
                    tot, acc = tot + acc / 256, torch.zeros(DH, DH)
            r, m = _ratio(tot + acc / 256, exact)
            out.setdefault(mode, []).append({"worst_ratio": r, "mean_abs_err": m})
    return out


def k21(args) -> dict:
    import torch
    g = torch.Generator().manual_seed(11)
    k = torch.randn((L, DH), generator=g).bfloat16()
    v = torch.randint(-127, 128, (L, DH), generator=g).float().bfloat16()
    phi = torch.softmax(k.float(), -1)
    h1 = (phi.view(torch.int32) & -65536).view(torch.float32)
    r1 = phi - h1
    h2 = (r1.view(torch.int32) & -65536).view(torch.float32)
    parts = [p.double() for p in (h1, h2, r1 - h2)]
    exact = torch.softmax(k.double(), -1).t() @ v.double()
    vd = v.double()
    out = {"frag_rows": args.frag, "model": args.model}
    for kahan in (False, True):
        tot, acc, comp = torch.zeros(DH, DH), torch.zeros(DH, DH), torch.zeros(DH, DH)
        for r0 in range(0, L, args.frag):
            r1_ = min(L, r0 + args.frag)
            # the fragment starts at minus the compensation (zero without)
            f = -comp.double()
            if args.model == "exact":
                y = (f + sum(p[r0:r1_].t() @ vd[r0:r1_] for p in parts)).float()
            else:
                for a in range(r0, r1_, 16):
                    sl = slice(a, min(r1_, a + 16))
                    for p in parts:
                        f = _tc_instr(f, p[sl], vd[sl], int(args.model[2:]))
                y = f.float()
            t = acc + y
            if kahan:
                comp = (t - acc) - y
            acc = t
            if r1_ % 9920 == 0 or r1_ == L:
                tot = tot + (acc - comp)
                acc, comp = torch.zeros(DH, DH), torch.zeros(DH, DH)
        r, m = _ratio(tot, exact)
        out["kahan" if kahan else "plain"] = {"worst_ratio": r, "mean_abs_err": m}
    return out


def phi32(args) -> dict:
    import torch
    g = torch.Generator().manual_seed(3)
    worst = 0.0
    for _ in range(args.heads):
        k = (torch.randn((L, DH), generator=g) * args.kstd).bfloat16()
        v = (torch.randn((L, DH), generator=g) * 50).round().clamp(-127, 127).bfloat16().double()
        exact = torch.softmax(k.double(), -1).t() @ v
        worst = max(worst, _ratio(torch.softmax(k.float(), -1).double().t() @ v, exact)[0])
    return {"heads": args.heads, "kstd": args.kstd, "worst_ratio": worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("k6", "tc", "k21", "phi32"))
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--run", type=int, default=24)
    p.add_argument("--frag", type=int, default=64)
    p.add_argument("--model", default="exact", choices=("exact", "tc0", "tc2", "tc3"))
    p.add_argument("--kstd", type=float, default=2.0)
    args = p.parse_args(argv)
    if args.heads is None:
        args.heads = {"k6": 40, "phi32": 8}.get(args.what, 3)
    print(json.dumps({"what": args.what, **globals()[args.what](args)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
