"""Card time of K4 (dense bf16 flash attention) and K22 (the 128 x 128
block-scaled W8A8 GEMM) at the main path's shapes.

Usage:
  python tools/time_k4_k22.py [--root DIR] [--label NAME] [--kernels k4,k22]
      [--models 1.3b,14b] [--rounds 5] [--reps 10] [--check]
  python tools/time_k4_k22.py --design [--kernels k4,k22] [--models ...]

K4, per model (12 or 40 heads of 128), a 480p/81f request's calls: the
cross attention (32,760 query rows over the 512 text keys) and the dense
self attention of `--attention_type original` (32,760 x 32,760); at 40
heads also the 720p dense self (75,600 x 75,600); at 12 heads the SLA
training step's 21-frame shapes (9,360 rows: cross and dense self). Inputs
N(0, 1) bf16, (B, L, H, 128) contiguous. `F.scaled_dot_product_attention`
on the same tensors is timed beside each (the port never calls it).

K22, per model, the GEMMs of a 480p/81f block-scale request (bf16 out, as
the path writes them): the self / cross projections 32,760 x D x D, fc1
32,760 x F x D, fc2 32,760 x D x F and the text K / V 512 x D x D (M x N x
K; D 1,536 / 5,120, F 8,960 / 13,824); int8 operands of std 60 clamped to
127, block scales spanning a factor of ~55, a bias. `torch._int_mm` on the
same int8 operands (the product alone) is timed beside each.

Each kernel is checked against its plain version (K4: bf16 atol 2e-2 +
rtol 2e-2; K22 bf16 out within one bf16 step) and timed with CUDA events
around `--reps` launches, `--rounds` rounds, and under torch.profiler:
`device_ms` is the device time a call spends in its kernel (names holding
`dense_fwd_kernel` or `flash_fwd_kernel` for K4, `gemm_kernel` for K22;
the library call: every kernel it launches) over `--reps` calls. One JSON
line per (kernel, shape): min / median / max ms, device ms, TFLOP/s or
TOP/s and the share of the bf16 or int8 dense peak (from device ms), the
bound, the library call's times, the error, and the card's name and power
limit. `--check` checks every shape once and times nothing (the first call
after a kernel change); a launch that has not finished within 60 s ends the
process. `--root DIR` imports the package from the checkout at DIR (a tree
unpacked beside this one), so two trees are timed by one script on one card.

`--design` times this tree's design variants: for each, a copy of the
package under `turbodiffusion_tpu_torch/_build/design/<name>` with one
kernel source patched (`DESIGNS`: FlashAttention-3's turn barriers in K4,
a block a tile in place of K4's persistent blocks, K22 on two consumers
or without clusters), each timed by this script with `--root` in a process
of its own. Its lines carry the variant's name.
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

MODELS = {"1.3b": (1536, 12, 8960), "14b": (5120, 40, 13824)}   # dim, heads, FFN
L, L720, L21, TEXT, DH = 32760, 75600, 9360, 512, 128
# the design calls' variants: (name, kernel, source under
# turbodiffusion_tpu_torch/, [(text, its replacement), ...]), each a patch of
# this tree's kernel (each text must occur once)
K4_SRC, K22_SRC = "csrc/flash_attention.cu", "csrc/quant.cu"
DESIGNS = [
    # FlashAttention-3's turn barriers: consumer cw issues its products after
    # a sync on named barrier 3 + cw and hands the turn on by arriving at the
    # other's; consumer 0 first, and it takes the last hand-over at the end
    ("k4-turns", "k4", K4_SRC, [
        ("namespace k4 {\n",
         "namespace k4 {\n\n__device__ __forceinline__ void named_arrive(int id, int count) {\n"
         "  asm volatile(\"bar.arrive %0, %1;\" ::\"r\"(id), \"r\"(count) : \"memory\");\n}\n"),
        ("  const int rl0 = warp * 16 + g;   // the warpgroup's row of registers with (i & 2) == 0\n",
         "  const int rl0 = warp * 16 + g;\n  if (cw == 1) named_arrive(3, 2 * kWG);\n"),
        ("      mbar_wait(kfull0 + 8 * s, (c / kStages) & 1);\n",
         "      mbar_wait(kfull0 + 8 * s, (c / kStages) & 1);\n"
         "      named_sync(3 + cw, 2 * kWG);\n"),
        ("      if (prev >= 0) issue_pv(prev, c - 1);\n",
         "      if (prev >= 0) issue_pv(prev, c - 1);\n"
         "      named_arrive(3 + (1 - cw), 2 * kWG);\n"),
        ("    // the last chunk's P V\n",
         "    // the last chunk's P V\n    named_sync(3 + cw, 2 * kWG);\n"),
        ("    issue_pv(prev, c - 1);\n    wgmma_wait<0>();",
         "    issue_pv(prev, c - 1);\n    named_arrive(3 + (1 - cw), 2 * kWG);\n"
         "    wgmma_wait<0>();"),
        ("  if (lt == 0) tma_store_wait_all();\n}",
         "  if (lt == 0) tma_store_wait_all();\n  if (cw == 0) named_sync(3, 2 * kWG);\n}"),
    ]),
    # a block a tile in place of persistent blocks
    ("k4-block-a-tile", "k4", K4_SRC, [
        ("  const int grid = blocks > n_sm ? n_sm : (int)blocks;",
         "  const int grid = (int)blocks;")]),
    # two consumers on 128 x 128 tiles in place of three on 192 x 128 (more
    # registers a thread, a stage more)
    ("k22-two-consumers", "k22", K22_SRC, [
        ("  static constexpr int NCW = 3;\n  static constexpr int THREADS = (NCW + 1) * kWG;\n"
         "  static constexpr int REGS = 128;\n  static constexpr int PRODUCER_REGS = 40;\n"
         "  static constexpr int CONSUMER_REGS = 152;\n",
         "  static constexpr int NCW = 2;\n  static constexpr int THREADS = (NCW + 1) * kWG;\n"
         "  static constexpr int REGS = 168;\n  static constexpr int PRODUCER_REGS = 40;\n"
         "  static constexpr int CONSUMER_REGS = 232;\n"),
        ("  static constexpr int STAGES = 5;\n  static constexpr int BM = 64 * NCW;\n",
         "  static constexpr int STAGES = 6;\n  static constexpr int BM = 64 * NCW;\n")]),
    # no clusters: every block loads its own activation tile
    ("k22-cluster-1", "k22", K22_SRC, [
        ("  const int csize = (p.N / kTN) % 2 ? 1 : 2;\n  CUtensorMap ta, tw;",
         "  const int csize = 1;\n  CUtensorMap ta, tw;")]),
]


def _k4_cases(model: str):
    _, heads, _ = MODELS[model]
    cases = [("cross", L, TEXT), ("dense self", L, L)]
    if heads == 40:
        cases.append(("dense self 720p", L720, L720))
    else:
        cases += [("21f cross", L21, TEXT), ("21f dense self", L21, L21)]
    return [(f"{what} {lq}x{lk}, {heads} heads", heads, lq, lk)
            for what, lq, lk in cases]


def _k22_cases(model: str):
    d, _, f = MODELS[model]
    return [("q/k/v/o", L, d, d), ("fc1", L, f, d), ("fc2", L, d, f),
            ("text k/v", TEXT, d, d)]


def _run_k4(args, base, randn):
    import torch
    import torch.nn.functional as F
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    for what, heads, lq, lk in _k4_cases(base["model"]):
        q = randn(1, lq, heads, DH)
        k, v = randn(1, lk, heads, DH), randn(1, lk, heads, DH)
        scale = DH ** -0.5
        ops = 4 * heads * lq * lk * DH
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound = max(ops / PEAK["bf16"], nbytes / HBM) * 1e3
        rec = {**base, "kernel": "K4", "shape": what}

        def kern():
            return fa._flash_cuda(q, k, v, scale, lk)

        try:
            got = kern()
            kt.sync()
            rec.update(kt.within(got, fa.flash_attention_plain(q, k, v, scale, lk), 2e-2, 2e-2))
        except Exception as e:          # a kernel that fails is reported
            print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
            continue
        del got
        if args.check:
            print(json.dumps(rec), flush=True)
            continue
        lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        ms = kt.times(kern, args.rounds, args.reps)
        dev = kt.device_ms(kern, args.reps, ("dense_fwd_kernel", "flash_fwd_kernel"))
        lib_ms = kt.times(lib, args.rounds, args.reps)
        print(json.dumps({
            **rec, "ms_min": min(ms), "ms_median": statistics.median(ms),
            "ms_max": max(ms), "device_ms": dev, "tflops": ops / dev * 1e-9,
            "peak_share": ops / dev * 1e3 / PEAK["bf16"], "bound_ms": bound,
            "sdpa_ms_median": statistics.median(lib_ms),
            "sdpa_device_ms": kt.device_ms(lib, args.reps, ("",))}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def _run_k22(args, base, randn):
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt

    def int8(*shape):
        return (randn(*shape).float() * 60).round().clamp(-127, 127).to(torch.int8)

    def scales(r, c):
        return 1e-3 * torch.exp(4 * randn(r, c).float().sigmoid())

    for what, M, N, K in _k22_cases(base["model"]):
        xq, wq = int8(M, K), int8(N, K)
        xs, ws = scales(-(-M // 128), K // 128), scales(N // 128, K // 128)
        b = randn(N).float() * 0.5
        ops = 2 * M * N * K
        rec = {**base, "kernel": "K22", "shape": f"{what} {M}x{N}x{K} + bias, bf16 out"}

        def kern():
            return qt._int8_block_matmul_cuda(xq, xs, wq, ws, b, torch.bfloat16)

        try:
            got = kern()
            kt.sync()
            want = qt.int8_block_matmul_plain(xq, xs, wq, ws, b, torch.bfloat16)
            rec.update(kt.within(got, want, 0.0, 2.0 ** -8))
        except Exception as e:
            print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
            continue
        del got
        if args.check:
            print(json.dumps(rec), flush=True)
            continue
        lib = lambda: torch._int_mm(xq, wq.t())                  # noqa: E731
        ms = kt.times(kern, args.rounds, args.reps)
        dev = kt.device_ms(kern, args.reps, ("gemm_kernel",))
        lib_ms = kt.times(lib, args.rounds, args.reps)
        print(json.dumps({
            **rec, "ms_min": min(ms), "ms_median": statistics.median(ms),
            "ms_max": max(ms), "device_ms": dev, "tops": ops / dev * 1e-9,
            "peak_share": ops / dev * 1e3 / PEAK["int8"],
            "bound_ms": ops / PEAK["int8"] * 1e3,
            "int_mm_ms_median": statistics.median(lib_ms),
            "int_mm_device_ms": kt.device_ms(lib, args.reps, ("",))}), flush=True)
        del xq, wq
        torch.cuda.empty_cache()


def _design(args) -> int:
    """Each variant of DESIGNS that concerns the kernels asked for: a copy
    of the package with its switch flipped, timed in a process of its own."""
    kernels = args.kernels.split(",")
    rc = 0
    for name, kern, src, edits in DESIGNS:
        if kern not in kernels:
            continue
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / src
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_k4_k22: {name}: text not found once in {src}: "
                                 f"{old!r}")
            text = text.replace(old, new)
        path.write_text(text)
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--kernels", kern, "--models", args.models, "--rounds", str(args.rounds),
               "--reps", str(args.reps)]
        rc |= subprocess.run(cmd).returncode
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--models", default="1.3b,14b")
    p.add_argument("--kernels", default="k4,k22")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--check", action="store_true",
                   help="check every shape against its plain version, time nothing")
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k4_k22")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    kernels = args.kernels.split(",")
    for model in args.models.split(","):
        base = {"label": args.label, "model": model, "card": card}
        if "k4" in kernels:
            _run_k4(args, base, randn)
        if "k22" in kernels:
            _run_k22(args, base, randn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
