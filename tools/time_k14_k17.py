"""Card time of K14 and K17, the cross attention with the int8 O feed, at
the main path's shapes.

Usage:
  python tools/time_k14_k17.py [--root DIR] [--label NAME] [--cases k14,k17,k17-720p]
      [--rounds 7] [--reps 20] [--check]
  python tools/time_k14_k17.py --design [--cases ...]

Shapes (480p/81f unless named; 512 text keys; heads of 128): K14 as the
1.3B W8A8 path calls it, the raw cross-Q rows 32,760 x 1536 (12 heads)
with their RMSNorm in the kernel; K17 as the 14B W8A8 path calls it,
32,760 x 5120 (40 heads) with K15's RMS inverse given, and at 720p
(75,600 rows). Inputs N(0, 1) bf16, norm weight 1 + N(0, 0.1^2), K and V
(B, 512, H, 128) contiguous. Beside each, on the same tensors: SDPA of the
cross shape (`F.scaled_dot_product_attention` on the normed q, attention
only, bf16 out) and K4 (`_flash_cuda`, the port's dense attention, bf16
out); neither computes the norm or the int8 feed, and the port never calls
SDPA.

Each kernel is checked against its plain version (int8 within 1 LSB,
scales rtol 5e-3: chip_smoke's K14_SCALE_RTOL) and timed with CUDA events
around `--reps` launches, `--rounds` rounds, and under torch.profiler
(`device_ms`: the device time a call spends in `cross_qout_kernel`, over
`--reps` calls). One JSON line per shape: min / median / max ms, device ms,
TFLOP/s and the share of the bf16 dense peak (from device ms), the bound
(4 B H Lq Lk 128 operations at 989 TFLOP/s, or the bytes of q, K, V, the
norm weight and the int8 and scale outputs at 3.35 TB/s), the yardsticks'
median and device ms, the error, and the card's name and power limit.
`--check` also checks the edge cases (a sharp q where one key of 512
dominates each row, a ragged Lq with kv_len 300, batch 2 with q a column
slice, kv_len 1100 past the one-pass key count, 1 to 16 heads) and times
nothing: the first call after a kernel change; a launch that has not
finished within 60 s ends the process. `--root DIR` imports the package
from the checkout at DIR, so two trees are timed by one script on one card.

`--design` times this tree's design variants (`DESIGNS`): for each, a copy
of the package under `turbodiffusion_tpu_torch/_build/design/<name>` with
one source patched, timed by this script with `--root` in a process of its
own. Its lines carry the variant's name.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys

import kernel_timing as kt
from kernel_timing import HBM, PEAK, ROOT

L, L720, TEXT, DH = 32760, 75600, 512, 128
# name: (heads, query rows, K17 (the RMS inverse given))
CASES = {"k14": (12, L, False), "k17": (40, L, True), "k17-720p": (40, L720, True)}
SRC = "ops/flash_attention.py"
# the design calls' variants: (name, source under turbodiffusion_tpu_torch/,
# [(text, its replacement), ...]), each text found once; `--designs` picks
KSRC = "csrc/flash_attention.cu"
_REGS = ("constexpr int kThreadsQ = 3 * kWG;          // producer warpgroup + two consumers\n"
         "constexpr int kRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;")
DESIGNS = [
    # setmaxnreg's split between the producer warpgroup and the consumers
    ("regs32", KSRC, [(_REGS, _REGS.replace("Regs = 24", "Regs = 32")
                       .replace("Regs = 240", "Regs = 232"))]),
    ("regs40", KSRC, [(_REGS, _REGS.replace("Regs = 24", "Regs = 40")
                       .replace("Regs = 240", "Regs = 232"))]),
    # 12 heads as clusters of 6 blocks of 2 heads or 4 of 3 (the default
    # takes 3 of 4)
    ("g2", SRC, [("    for g in (4, 3, 2, 1):", "    for g in ((2, 1) if H == 12 else (4, 3, 2, 1)):")]),
    ("g3", SRC, [("    for g in (4, 3, 2, 1):", "    for g in ((3, 2, 1) if H == 12 else (4, 3, 2, 1)):")]),
]


def _inputs(randn, heads: int, lq: int, ext: bool, B: int = 1, kv_len: int = TEXT,
            ld: int = 0, sharp: bool = False):
    """(q, rms_inv or None, k, v, w): q (B, lq, heads * 128), a column slice
    of rows `ld` wide when ld > 0; sharp: each row one of 8 directions whose
    key (spread over all of [0, kv_len)) has logits ~136 above the rest."""
    import torch
    from turbodiffusion_tpu_torch.models.layers import rms_norm
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    HD = heads * DH
    w = (1 + 0.1 * randn(HD).float()).bfloat16()
    if sharp:
        d = randn(B, 8, HD)
        x = (d[:, torch.arange(lq, device=d.device) % 8]
             + 0.05 * randn(B, lq, HD).float()).bfloat16()
    else:
        x = randn(B, lq, ld or HD)
    q = x[..., :HD]
    k, v = randn(B, kv_len, heads, DH), randn(B, kv_len, heads, DH)
    if sharp:
        keys = torch.linspace(0, kv_len - 1, 8).long()
        k[:, keys] = (12 * rms_norm(d, w, 1e-6).float()).bfloat16().view(B, 8, heads, DH)
    ri = sf.row_rms_inv_plain(q, 1e-6) if ext else None
    return q, ri, k, v, w


def _launch(ext: bool):
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    if ext:
        return lambda q, ri, k, v, w: fa._cross_qout_wide_cuda(q, ri, k, v, w, DH ** -0.5)
    return lambda q, ri, k, v, w: fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6)


def _plain(ext: bool):
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    if ext:
        return lambda q, ri, k, v, w: fa.cross_attention_qout_wide_plain(
            q, ri, k, v, w, DH ** -0.5)
    return lambda q, ri, k, v, w: fa.cross_attention_qout_plain(q, k, v, w, DH ** -0.5, 1e-6)


def _ptxas() -> dict:
    """ptxas's registers, stack frame and spill stores of K14 / K17's
    kernel, when this process built the library (else empty)."""
    import re
    from turbodiffusion_tpu_torch.ops import _build
    out, name = {}, None
    for ln in _build.load().build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*cross_qout_kernelILb([01])", ln)
        if m:
            name = "K17" if m.group(1) == "1" else "K14"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} B stack, {m.group(2)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
            name = None
    return out


def _compare(got, want) -> dict:
    """int8 within 1 LSB, scales rtol 5e-3."""
    lsb = int((got[0].int() - want[0].int()).abs().max())
    srel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    return {"int8_max_lsb": lsb, "scale_max_rel": srel,
            "ok": lsb <= 1 and srel <= 5e-3 and bool(got[1].isfinite().all())}


def _check_edges(base, randn) -> None:
    """The edge cases, each against its plain version."""
    edges = [("sharp q, 12 heads", 12, 4096, False, {"sharp": True}),
             ("sharp q, 40 heads", 40, 2048, True, {"sharp": True}),
             ("ragged Lq 1000, kv_len 300, 12 heads", 12, 1000, False, {"kv_len": 300}),
             ("ragged Lq 1000, kv_len 300, 40 heads", 40, 1000, True, {"kv_len": 300}),
             ("batch 2, q a column slice (3 x 1536 wide)", 12, 2000, False,
              {"B": 2, "ld": 3 * 12 * DH}),
             ("batch 2, q a column slice (2 x 5120 wide)", 40, 1000, True,
              {"B": 2, "ld": 2 * 40 * DH}),
             ("kv_len 1100 (two passes), 12 heads", 12, 1000, False, {"kv_len": 1100}),
             ("kv_len 1100 (two passes), 40 heads", 40, 700, True, {"kv_len": 1100}),
             ("kv_len 50 (one chunk), 12 heads", 12, 300, False, {"kv_len": 50})]
    edges += [(f"{h} heads, kv_len 77", h, 333, False, {"kv_len": 77}) for h in (1, 2, 5, 16)]
    for what, heads, lq, ext, kw in edges:
        rec = {**base, "kernel": "K17" if ext else "K14", "shape": what}
        ins = _inputs(randn, heads, lq, ext, **kw)
        try:
            got = _launch(ext)(*ins)
            kt.sync()
            rec.update(_compare(got, _plain(ext)(*ins)))
        except Exception as e:          # a kernel that fails is reported
            rec["error"] = str(e)[:300]
        print(json.dumps(rec), flush=True)


def _run(args, base, randn) -> None:
    import torch
    import torch.nn.functional as F
    from turbodiffusion_tpu_torch.models.layers import rms_norm
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    for name in args.cases.split(","):
        heads, lq, ext = CASES[name]
        q, ri, k, v, w = ins = _inputs(randn, heads, lq, ext)
        kern = lambda: _launch(ext)(*ins)                      # noqa: E731
        ops = 4 * heads * lq * TEXT * DH
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + w.numel()) + q.numel() + 4 * lq
        bound = max(ops / PEAK["bf16"], nbytes / HBM) * 1e3
        rec = {**base, "kernel": "K17" if ext else "K14",
               "shape": f"{name}: q-norm + cross {lq}x{TEXT} -> int8, {heads} heads"}
        try:
            got = kern()
            kt.sync()
            rec.update(_compare(got, _plain(ext)(*ins)))
        except Exception as e:
            print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
            continue
        del got
        if args.check:
            print(json.dumps(rec), flush=True)
            continue
        qn = rms_norm(q, w, 1e-6).reshape(1, lq, heads, DH)
        sdpa = lambda: F.scaled_dot_product_attention(         # noqa: E731
            qn.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        k4 = lambda: fa._flash_cuda(qn, k, v, DH ** -0.5, TEXT)   # noqa: E731
        ms = kt.times(kern, args.rounds, args.reps)
        dev = kt.device_ms(kern, args.reps, ("cross_qout_kernel",))
        out = {**rec, "ms_min": min(ms), "ms_median": statistics.median(ms),
               "ms_max": max(ms), "device_ms": dev, "tflops": ops / dev * 1e-9,
               "peak_share": ops / dev * 1e3 / PEAK["bf16"], "bound_ms": bound}
        for yname, fn in (("sdpa", sdpa), ("k4", k4)):
            out[f"{yname}_ms_median"] = statistics.median(kt.times(fn, args.rounds, args.reps))
            out[f"{yname}_device_ms"] = kt.device_ms(
                fn, args.reps,
                ("",) if yname == "sdpa" else ("dense_fwd_kernel", "flash_fwd_kernel<false>", "flash_fwd_kernel<0>"))
        print(json.dumps(out), flush=True)
        del q, ri, k, v, w, ins, qn
        torch.cuda.empty_cache()


def _design(args) -> int:
    """Each variant of DESIGNS: a copy of the package with its patch, timed
    in a process of its own."""
    rc = 0
    for name, src, edits in DESIGNS:
        if args.designs and name not in args.designs.split(","):
            continue
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / src
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_k14_k17: {name}: text not found once in {src}: "
                                 f"{old!r}")
            text = text.replace(old, new)
        path.write_text(text)
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--cases", args.cases, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        rc |= subprocess.run(cmd).returncode
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--cases", default="k14,k17,k17-720p")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--check", action="store_true",
                   help="check every shape and the edge cases, time nothing")
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    p.add_argument("--designs", default="", help="with --design: these variants only")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k14_k17")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    base = {"label": args.label, "card": card}
    print(json.dumps({**base, "ptxas": _ptxas()}), flush=True)
    _run(args, base, randn)
    if args.check:
        _check_edges(base, randn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
