"""Card time of K9 (the W8A8 postscale GEMM) and K7 (int8 block-sparse
SageSLA attention) at the main path's shapes.

Usage:
  python tools/time_k9_k7.py [--root DIR] [--label NAME] [--models 1.3b,14b]
      [--kernels k9,k7] [--rounds 5] [--reps 10]

K9, per model, each linear of a 480p/81f Wan2.1 block that K9 computes:
the self-attention Q (the 1.3B's fused QKV) with bias, the O projection
with bias, gate and residual, and the text-side K (512 rows) with bias;
activations N(0, 1) through K8's plain version, weights N(0, 1/fan_in)
through the port's per-channel quantiser. `torch._int_mm` on the same int8
operands (the product alone) is timed beside each.

K7, per model (12 or 40 heads of 128), the fused sagesla call of a
480p/81f request: 32,760 tokens padded to 32,768, blocks 512/256, 12 of the
128 K blocks a Q block (a seeded random LUT), with and without the SLA
linear-branch epilogue; int8 Q with row scales, K6's smooth-k panels and
per-channel V from their plain versions. Its bound counts the query-key
pairs these inputs need (rows and keys past 32,760 left out), QK at the
int8 and P V at the bf16 peak.

Each kernel is checked against its plain version (bf16 atol 2e-2 + rtol
2e-2) and timed with CUDA events around `--reps` launches, `--rounds`
rounds (which counts the wrapper's host time where a launch is shorter),
and under torch.profiler: `device_ms` is the device time a call spends
in the kernel itself, over `--reps` calls (K9's and K7's kernel names hold
`gemm_kernel`, `sparse_i8_vt_kernel`; `torch._int_mm`: every kernel it
launches). One JSON line per (model, shape):
min / median / max ms, device ms, TOP/s (K9: and the share of the 1,979
TOP/s int8 peak, from device ms), the bound, the errors, and the card's
name and power limit. `--root DIR` imports the package from
the checkout at DIR (another tree unpacked beside this one), so two trees
are timed by one script, in turns, on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import kernel_timing as kt
from kernel_timing import PEAK
MODELS = {"1.3b": (1536, 12, True), "14b": (5120, 40, False)}   # dim, heads, fused QKV
L, LP, TEXT, DH, BQ, BK, SEL = 32760, 32768, 512, 128, 512, 256, 12


def _errors(got, want) -> dict:
    return kt.within(got, want, 2e-2, 2e-2)


def _k9_cases(model: str, randn):
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt
    dim, _, fused = MODELS[model]
    x2, c2 = randn(L, dim), randn(TEXT, dim)
    xq, rs = qt.quantize_rows_int8_plain(x2)
    cq, crs = qt.quantize_rows_int8_plain(c2)
    n_q = 3 * dim if fused else dim

    def weight(n):
        return qt.quantize_int8_postscale(randn(n, dim, std=dim ** -0.5))

    (wq, sq), (wo, so), (wk, sk) = weight(n_q), weight(dim), weight(dim)
    bq, bo = randn(n_q, std=0.1), randn(dim, std=0.1)
    gate = randn(dim, std=0.5).float()
    return [
        (f"{'fused QKV' if fused else 'Q'} + bias", xq, wq,
         lambda: qt._int8_gemm_postscale_cuda(xq, rs, wq, sq, bq, None, None, None),
         lambda: qt.int8_gemm_postscale_plain(xq, rs, wq, sq, bq)),
        ("O + bias, gate, residual", xq, wo,
         lambda: qt._int8_gemm_postscale_cuda(xq, rs, wo, so, bo, None, gate, x2),
         lambda: qt.int8_gemm_postscale_plain(xq, rs, wo, so, bo, gate=gate,
                                              residual=x2)),
        ("text K + bias", cq, wk,
         lambda: qt._int8_gemm_postscale_cuda(cq, crs, wk, sk, bo, None, None, None),
         lambda: qt.int8_gemm_postscale_plain(cq, crs, wk, sk, bo)),
    ]


def _k7_operands(model: str, randn, g):
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    _, heads, _ = MODELS[model]
    qi, qs = sf._quant_rows(randn(1, heads, LP, DH, std=2.0).float())
    k = randn(1, heads, LP, DH)
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(randn(1, heads, LP, DH), L)
    kp, vtp, ks, kv, ksum = sf.subquant_pack_kvt_plain(k, mu, vi, BK, L, True)
    nq, nk = LP // BQ, LP // BK
    lut = torch.argsort(torch.rand(heads * nq, nk, generator=g, device="cuda"),
                        dim=1)[:, :SEL].reshape(1, heads, nq, SEL).int()
    proj = randn(DH, DH, std=0.3 / math.sqrt(DH)).float()
    lin = dict(lin_kvw=torch.matmul(kv * vcs, proj.t()),
               lin_ks_bias=torch.cat([ksum, randn(1, heads, 1, DH, std=0.1).float()], 2))
    return (qi, qs, kp, vtp, ks, vcs, lut), lin


def _pairs(lut) -> int:
    """Query-key pairs of the valid rows and keys these LUT rows select."""
    import torch
    nq = lut.shape[2]
    q_rows = (L - torch.arange(nq, device=lut.device) * BQ).clamp(max=BQ)
    k_rows = (L - lut.long() * BK).clamp(min=0, max=BK)
    return int((k_rows.sum(-1) * q_rows).sum())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--models", default="1.3b,14b")
    p.add_argument("--kernels", default="k9,k7")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    kt.use_root(args.root)

    import torch
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8

    card = kt.card("time_k9_k7")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    kernels = args.kernels.split(",")
    for model in args.models.split(","):
        base = {"label": args.label, "model": model, "card": card}
        if "k9" in kernels:
            for what, a, w, kern, plain in _k9_cases(model, randn):
                M, K, N = a.shape[0], a.shape[1], w.shape[0]
                ops = 2 * M * N * K
                rec = {**base, "kernel": "K9", "shape": f"{what} {M}x{N}x{K}"}
                try:
                    rec.update(_errors(kern(), plain()))
                except Exception as e:          # a kernel that fails is reported
                    print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
                    continue
                ms = kt.times(kern, args.rounds, args.reps)
                dev = kt.device_ms(kern, args.reps, ("gemm_kernel",))
                lib = kt.times(lambda: torch._int_mm(a, w.t()), args.rounds, args.reps)
                lib_dev = kt.device_ms(lambda: torch._int_mm(a, w.t()), args.reps)
                print(json.dumps({
                    **rec, "ms_min": min(ms), "ms_median": statistics.median(ms),
                    "ms_max": max(ms), "device_ms": dev, "tops": ops / dev * 1e-9,
                    "peak_share": ops / dev * 1e3 / PEAK["int8"],
                    "bound_ms": ops / PEAK["int8"] * 1e3,
                    "int_mm_ms_median": statistics.median(lib),
                    "int_mm_device_ms": lib_dev}), flush=True)
            torch.cuda.empty_cache()
        if "k7" in kernels:
            args7, lin = _k7_operands(model, randn, g)
            pairs = _pairs(args7[-1])
            ops = {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs}
            bound = sum(n / PEAK[t] for t, n in ops.items()) * 1e3
            kw = dict(block_q=BQ, block_k=BK, kv_len=L)
            for what, extra in (("", {}), (" + linear epilogue", lin)):
                rec = {**base, "kernel": "K7",
                       "shape": f"{args7[0].shape[1]} heads, {SEL}/{LP // BK} blocks "
                                f"{BQ}/{BK}{what}"}

                def kern(extra=extra):
                    return si8._sparse_i8_vt_cuda(
                        *args7, DH ** -0.5, BQ, BK, L, extra.get("lin_kvw"),
                        extra.get("lin_ks_bias"))

                try:
                    rec.update(_errors(kern(), si8.sparse_attention_i8_vt_plain(
                        *args7, **kw, **extra)))
                except Exception as e:
                    print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
                    continue
                ms = kt.times(kern, args.rounds, args.reps)
                dev = kt.device_ms(kern, args.reps, ("sparse_i8_vt_kernel",))
                print(json.dumps({
                    **rec, "ms_min": min(ms), "ms_median": statistics.median(ms),
                    "ms_max": max(ms), "device_ms": dev,
                    "tops": sum(ops.values()) / dev * 1e-9, "bound_ms": bound,
                    "bound_share": bound / dev}), flush=True)
            del args7, lin
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
