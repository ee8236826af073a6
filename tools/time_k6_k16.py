"""Card time of K6 (`subquant_pack_kvt`, the SageSLA K / V pack, with and
without the linear branch's kv sums) and K16 (the wide int8 O feed,
`unfold_quant` above 4096 wide), with a copy of the same bytes beside them.

Usage:
  python tools/time_k6_k16.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 7] [--reps 20] [--draws 1]
  python tools/time_k6_k16.py --design [--designs NAME,...] [--cases ...]

Launches the port's launchers on seeded random inputs shaped as the fused
path gives them and prints one JSON line per case:
  * K6 (`_subquant_pack_kvt_cuda`) at 12 and 40 heads (1.3B, 14B), 480p:
    K planes (1, H, 32,768, 128) bf16 with 32,760 live rows, int8 V, 256-row
    blocks, with (`+kv`) and without the linear branch's kv / ksum sums. On
    an older tree the same call launches its pack kernel and then its
    separate kv pass: the same function;
  * K16 (`_unfold_quant_wide_cuda`) over (1, 40, Lp, 128) bf16 planes at
    480p (32,760 rows) and 720p (75,600 rows);
  * a copy of as many bytes as each case reads and writes (`copy_` of a
    uint8 buffer of half of them): what the card reaches in practice.
Each line holds the time a call takes (CUDA events around `--reps` calls,
`--rounds` rounds: min, median, max), the device time of the call's
kernels from torch.profiler (the wrapper's host time left out), the bound
(each input read once, each output written once, at 3.35 TB/s, or the kv
sums' two fp16 products at the dense peak, whichever is longer; for K6 with
the kv sums also `bound_ms_design`, with the partial sums this tree's
design writes and reads again) and the share of it the median reaches, the
largest difference from the plain version on the same inputs (int8 in LSB,
scales relative; kv and ksum also from float64 sums, and the largest ratio
of that difference to rtol 1e-4 / atol 1e-4; with `--draws N` that ratio
on N - 1 further draws too: `kv_tol_ratio_f64_draws`), the form the
launch takes where the tree names one (K6's blocks and runs) and the card's
name and power limit. `--root DIR` imports the package from the checkout at
DIR (another tree unpacked beside this one), so two trees are timed by one
script, in turns, on one card. `--design` times this tree's design variants
(`DESIGNS`): for each, a copy of the package under
`turbodiffusion_tpu_torch/_build/design/<name>` with its kernel sources
patched, timed in a process of its own.
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

DH, L480, L720, BK = 128, 32760, 75600, 256
CASES = ("k6-12", "k6-12+kv", "k6-40", "k6-40+kv", "k16-480p", "k16-720p")

# the design variants: (name, [(file under csrc/, its text, the
# replacement), ...]). K6's runs with the linear branch at most 8 or 12 K
# blocks, or any length in one wave (this tree: 24); the repairs of its kv
# sums' rounding tried for ROADMAP Queue C 5 (the Kahan compensation, kept
# apart or carried in the fragment, with mu in shared memory or the updates
# ordered; the runs' partials reduced in float64); K16 on 1 or 4 warps a
# row (this tree: 2, 10 vectors a lane); K6's step fragments summed with a
# Kahan compensation (ROADMAP Queue C 5; its kv_tol_ratio_f64 and its
# time). The "-ablate" variants leave a piece of K6's work out (their
# outputs are wrong; their times say what the piece costs): the exp's
# residual correction, the kv products on the tensor cores, the
# transposed V panel
# K6's step sums under a Kahan compensation that costs no registers: the
# fragment starts each step at minus the compensation (the first product
# accumulates onto it), then t = acc + frag, frag = frag - (t - acc), acc =
# t; a partial is acc + frag (K21's kv pass sums its fragments so)
_K6_CARRY = [
    ("sla_fused.cu",
     "wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_hi + ks16 * 2048, 0), db, ks16);",
     "wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_hi + ks16 * 2048, 0), db, 1);"),
    ("sla_fused.cu", "for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);",
     "for (int i = 0; i < 32; ++i) {\n"
     "          const float t = __fadd_rn(acc[i], frag[i]);\n"
     "          frag[i] = __fsub_rn(frag[i], __fsub_rn(t, acc[i]));\n"
     "          acc[i] = t;\n        }"),
    ("sla_fused.cu", "  if constexpr (LINEAR) {\n#pragma unroll\n"
     "    for (int i = 0; i < 32; ++i) acc[i] = 0.f;",
     "  if constexpr (LINEAR) {\n#pragma unroll\n"
     "    for (int i = 0; i < 32; ++i) acc[i] = frag[i] = 0.f;"),
    ("sla_fused.cu", "#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] = 0.f;",
     "#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] = frag[i] = 0.f;"),
    ("sla_fused.cu", "make_float2(acc[4 * jn] * kPhiUnscale, acc[4 * jn + 1] * kPhiUnscale);",
     "make_float2(__fadd_rn(acc[4 * jn], frag[4 * jn]) * kPhiUnscale,\n"
     "                          __fadd_rn(acc[4 * jn + 1], frag[4 * jn + 1]) * kPhiUnscale);"),
    ("sla_fused.cu",
     "make_float2(acc[4 * jn + 2] * kPhiUnscale, acc[4 * jn + 3] * kPhiUnscale);",
     "make_float2(__fadd_rn(acc[4 * jn + 2], frag[4 * jn + 2]) * kPhiUnscale,\n"
     "                          __fadd_rn(acc[4 * jn + 3], frag[4 * jn + 3]) * kPhiUnscale);"),
]

# the same, each element's update ordered before the next's by an empty
# volatile asm (ptxas scheduled the 32 updates side by side and spilled)
_K6_CARRY_SEQ = [e if "acc[i] = __fadd_rn(acc[i], frag[i])" not in e[1] else (
    e[0], e[1], "for (int i = 0; i < 32; ++i) {\n"
    "          const float t = __fadd_rn(acc[i], frag[i]);\n"
    "          frag[i] = __fsub_rn(frag[i], __fsub_rn(t, acc[i]));\n"
    "          acc[i] = t;\n"
    "          asm volatile(\"\" : \"+f\"(acc[i]), \"+f\"(frag[i]));\n        }") for e in _K6_CARRY]

# the mean mu of the head in shared memory, read at each use, where the
# thread held its 8 channels in registers (8 registers for the carry)
_K6_MU_SMEM = [
    ("sla_fused.cu", "  __shared__ float red[kThreads / 32];\n  const uint32_t raw",
     "  __shared__ float red[kThreads / 32];\n  __shared__ __align__(16) float mu_s[kDh];\n"
     "  const uint32_t raw"),
    ("sla_fused.cu", "  float m8[8];\n  float acc[LINEAR", "  float acc[LINEAR"),
    ("sla_fused.cu",
     "      const float4* m4 = reinterpret_cast<const float4*>(mu + (size_t)bh * kDh + c16 * 8);\n"
     "      *reinterpret_cast<float4*>(m8) = __ldg(m4);\n"
     "      *reinterpret_cast<float4*>(m8 + 4) = __ldg(m4 + 1);\n",
     "      if (tid < kDh / 4)\n"
     "        reinterpret_cast<float4*>(mu_s)[tid] =\n"
     "            __ldg(reinterpret_cast<const float4*>(mu + (size_t)bh * kDh) + tid);\n"
     "      __syncthreads();\n"),
    ("sla_fused.cu",
     "      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fsub_rn(f[e], m8[e])));",
     "      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fsub_rn(f[e], mu_s[c16 * 8 + e])));"),
    ("sla_fused.cu", "        for (int e = 0; e < 8; ++e) f[e] = __fsub_rn(f[e], m8[e]);",
     "        for (int e = 0; e < 8; ++e) f[e] = __fsub_rn(f[e], mu_s[c16 * 8 + e]);"),
]

DESIGNS = [
    ("k6-run8", [("sla_fused.cu", "constexpr int kMaxRun = 24;", "constexpr int kMaxRun = 8;")]),
    ("k6-run12", [("sla_fused.cu", "constexpr int kMaxRun = 24;",
                   "constexpr int kMaxRun = 12;")]),
    ("k6-run-one-wave", [("sla_fused.cu", "constexpr int kMaxRun = 24;",
                          "constexpr int kMaxRun = 1 << 20;")]),
    ("k16-rw1", [("sla_fused.cu", "constexpr int kWideRowWarps = 2;",
                  "constexpr int kWideRowWarps = 1;")]),
    ("k16-rw4", [("sla_fused.cu", "constexpr int kWideRowWarps = 2;",
                  "constexpr int kWideRowWarps = 4;")]),
    ("k6-expfix-ablate", [("linear_kv.cuh", "return fmaf(p2, r * kLn2, p2);", "return p2;")]),
    ("k6-mma-ablate", [
        ("sla_fused.cu",
         "wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_hi + ks16 * 2048, 0), db, ks16);", ""),
        ("sla_fused.cu", "wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_lo + ks16 * 2048, 0), db, 1);",
         "")]),
    ("k6-fence-ablate", [("sla_fused.cu", "        fence_async_shared();\n        __syncthreads();\n"
                          "        // warpgroup g", "        __syncthreads();\n        // warpgroup g")]),
    ("k6-phi-ablate", [("linear_kv.cuh", "  const float p2 = ex2_approx(y);",
                        "  const float p2 = y;")]),
    ("k6-kahan", [
        ("sla_fused.cu", "  float acc[LINEAR ? 32 : 1], frag[LINEAR ? 32 : 1], ksl[8];",
         "  float acc[LINEAR ? 32 : 1], frag[LINEAR ? 32 : 1], ksl[8], comp[LINEAR ? 32 : 1];"),
        ("sla_fused.cu", "  if constexpr (LINEAR) {\n#pragma unroll\n"
         "    for (int i = 0; i < 32; ++i) acc[i] = 0.f;",
         "  if constexpr (LINEAR) {\n#pragma unroll\n"
         "    for (int i = 0; i < 32; ++i) acc[i] = comp[i] = 0.f;"),
        ("sla_fused.cu", "#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] = 0.f;",
         "#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] = comp[i] = 0.f;"),
        ("sla_fused.cu", "for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);",
         "for (int i = 0; i < 32; ++i) {\n"
         "          const float y = __fsub_rn(frag[i], comp[i]), t = __fadd_rn(acc[i], y);\n"
         "          comp[i] = __fsub_rn(__fsub_rn(t, acc[i]), y);\n"
         "          acc[i] = t;\n        }"),
        ("sla_fused.cu", "make_float2(acc[4 * jn] * kPhiUnscale, acc[4 * jn + 1] * kPhiUnscale);",
         "make_float2((acc[4 * jn] - comp[4 * jn]) * kPhiUnscale,\n"
         "                          (acc[4 * jn + 1] - comp[4 * jn + 1]) * kPhiUnscale);"),
        ("sla_fused.cu",
         "make_float2(acc[4 * jn + 2] * kPhiUnscale, acc[4 * jn + 3] * kPhiUnscale);",
         "make_float2((acc[4 * jn + 2] - comp[4 * jn + 2]) * kPhiUnscale,\n"
         "                          (acc[4 * jn + 3] - comp[4 * jn + 3]) * kPhiUnscale);")]),
    ("k6-carry", _K6_CARRY),
    ("k6-carry-run8", _K6_CARRY + [("sla_fused.cu", "constexpr int kMaxRun = 24;",
                                    "constexpr int kMaxRun = 8;")]),
    ("k6-carry-run12", _K6_CARRY + [("sla_fused.cu", "constexpr int kMaxRun = 24;",
                                     "constexpr int kMaxRun = 12;")]),
    ("k6-carry-mu", _K6_CARRY + _K6_MU_SMEM),
    ("k6-carry-seq", _K6_CARRY_SEQ),
    ("k6-reduce-f64-run8", [
        ("sla_fused.cu", "constexpr int kMaxRun = 24;", "constexpr int kMaxRun = 8;"),
        ("linear_kv.cuh", "  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);",
         "  double sx = 0.0, sy = 0.0, sz = 0.0, sw = 0.0;"),
        ("linear_kv.cuh", "    sum.x += q.x; sum.y += q.y; sum.z += q.z; sum.w += q.w;",
         "    sx += q.x; sy += q.y; sz += q.z; sw += q.w;"),
        ("linear_kv.cuh", "  *reinterpret_cast<float4*>(out) = sum;",
         "  *reinterpret_cast<float4*>(out) = make_float4(sx, sy, sz, sw);")]),
    ("k6-transpose-ablate", [("sla_fused.cu",
                              "  const int cq = u & 7, r8 = (r0 >> 3) + (u >> 3);",
                              "  return;\n  const int cq = u & 7, r8 = (r0 >> 3) + (u >> 3);")]),
]


def _design(args) -> int:
    """Each variant of DESIGNS: a copy of the package with its kernel
    sources patched, timed in a process of its own."""
    rc = 0
    for name, edits in DESIGNS:
        if args.designs and name not in args.designs.split(","):
            continue
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for src, old, new in edits:
            path = dst / "turbodiffusion_tpu_torch" / "csrc" / src
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"time_k6_k16: {name}: text not found once: {old!r}")
            path.write_text(text.replace(old, new))
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--cases", args.cases, "--rounds", str(args.rounds), "--reps", str(args.reps),
               "--draws", str(args.draws)]
        rc |= subprocess.run(cmd).returncode
    return rc


def _ptxas() -> dict:
    """ptxas's registers, stack frame and spill stores of K6's and K16's
    kernels, when this process built the library (else empty)."""
    import re
    from turbodiffusion_tpu_torch.ops import _build
    out, name = {}, None
    for ln in _build.load().build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w*(pack_kvt_kernel|kv_reduce_kernel|"
                      r"unfold_quant_wide_kernel|subquant_block_kernel)\w*)'", ln)
        if m:
            name = m.group(2) + ("<true>" if "ILb1E" in m.group(1) else
                                 "<false>" if "ILb0E" in m.group(1) else "")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} B stack, {m.group(2)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
            name = None
    return out


def _int8_lsb(a, b) -> int:
    return int((a.int() - b.int()).abs().max())


def _record(args, base: dict, run, check, nbytes: int, ops: float, extra=None) -> None:
    """Check `run` (check(got) -> its differences), time it, print a line."""
    import torch
    rec = dict(base)
    got = run()
    rec.update(check(got))
    del got
    torch.cuda.synchronize()
    rec.update(extra or {})
    ms = kt.times(run, args.rounds, args.reps)
    bound = max(nbytes / HBM, ops / PEAK["bf16"]) * 1e3
    rec.update(ms_min=min(ms), ms_median=statistics.median(ms), ms_max=max(ms),
               device_ms=kt.device_ms(run, args.reps), bound_ms=bound,
               share_of_bound=bound / statistics.median(ms))
    rec["device_share_of_bound"] = bound / rec["device_ms"]
    if "bound_ms_design" in rec:
        rec["device_share_of_bound_design"] = rec["bound_ms_design"] / rec["device_ms"]
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _copy(args, base: dict, nbytes: int) -> None:
    """A copy of nbytes / 2 bytes: nbytes read and written in all."""
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    _record(args, {**base, "kernel": "copy", "bytes": nbytes}, lambda: dst.copy_(src),
            lambda got: {}, nbytes, 0.0)


def _k6_draw(H: int, seed: int):
    """K planes of N(0, 1) (rows past L zero, as K5 leaves them), their
    mean, uniform int8 V (rows past L zero)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    Lp, L = -(-L480 // 512) * 512, L480
    k = torch.randn((1, H, Lp, DH), generator=g, device="cuda").bfloat16()
    k[:, :, L:] = 0                                  # K5's rows past L
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi = torch.randint(-127, 128, (1, H, Lp, DH), generator=g, device="cuda",
                       dtype=torch.int8)
    vi[:, :, L:] = 0
    return k, mu, vi


def _kv_tol_ratio(sf, k, mu, vi) -> float:
    """K6's kv: the worst |err| over rtol / atol 1e-4 of the float64 sums."""
    import torch
    L = L480
    pk = torch.softmax(k[:, :, :L].double(), -1)
    ref = torch.matmul(pk.transpose(-1, -2), vi[:, :, :L].double())
    got = sf._subquant_pack_kvt_cuda(k, mu, vi, BK, L, True)[3]
    return float(((got.double() - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max())


def _k6(args, card: str, sf, H: int, linear: bool) -> None:
    import torch
    Lp, L = -(-L480 // 512) * 512, L480
    k, mu, vi = _k6_draw(H, H)
    nK = Lp // BK
    n_in = k.numel() * 2 + vi.numel() + mu.numel() * 4
    n_out = 2 * vi.numel() + 4 * H * nK + (4 * H * DH * (DH + 1) if linear else 0)
    ops = 2 * 2 * H * L * DH * DH if linear else 0.0      # hi and lo products
    base = {"label": args.label, "kernel": "K6", "heads": H, "rows": L, "block_k": BK,
            "linear_kv": linear, "card": card}
    extra = {}
    if hasattr(sf, "kvt_grid"):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        grid = sf._kvt_grid_on_card(0, 1, H, Lp, BK, linear)
        extra["form"] = f"one pass, {grid} blocks ({n_sm} SMs), runs of " \
                        f"{(H * nK) // grid}-{-(-H * nK // grid)} K blocks"
        if linear:
            n_part = sum(len(p) for p in sf.kvt_partials(1, H, nK, grid))
            extra["partials"] = n_part
            extra["bound_ms_design"] = max(
                (n_in + n_out + 2 * n_part * 4 * DH * (DH + 1)) / HBM, ops / PEAK["bf16"]) * 1e3
    if linear and args.draws > 1:
        # the kv sums' worst element on further draws (seeds 1000 H + i)
        extra["kv_tol_ratio_f64_draws"] = [
            _kv_tol_ratio(sf, *_k6_draw(H, 1000 * H + i)) for i in range(1, args.draws)]
    want = sf.subquant_pack_kvt_plain(k, mu, vi, BK, L, linear)
    ref = None
    if linear:                                      # float64 sums (the plain's own, or not)
        pk = torch.softmax(k[:, :, :L].double(), -1)
        ref = (torch.matmul(pk.transpose(-1, -2), vi[:, :, :L].double()),
               pk.sum(2, keepdim=True))

    def check(got):
        d = {"max_int8_diff": max(_int8_lsb(got[0], want[0]), _int8_lsb(got[1], want[1])),
             "max_scale_rel_err": float(((got[2] - want[2]).abs() / want[2]).max())}
        if linear:
            for i, key in ((3, "kv"), (4, "ksum")):
                d[f"{key}_max_abs_err"] = float((got[i] - want[i]).abs().max())
                err = (got[i].double() - ref[i - 3]).abs()
                d[f"{key}_max_abs_err_f64"] = float(err.max())
                # the worst error over the card tests' rtol 1e-4 / atol 1e-4
                d[f"{key}_tol_ratio_f64"] = float((err / (1e-4 + 1e-4 * ref[i - 3].abs())).max())
        return d

    _record(args, base, lambda: sf._subquant_pack_kvt_cuda(k, mu, vi, BK, L, linear), check,
            n_in + n_out, ops, extra)
    del k, vi, want, ref
    _copy(args, {"label": args.label, "for": f"k6-{H}" + ("+kv" if linear else ""),
                 "card": card}, n_in + n_out)


def _k16(args, card: str, sf, L: int) -> None:
    import torch
    g = torch.Generator(device="cuda").manual_seed(L)
    H, Lp = 40, -(-L // 512) * 512
    planes = (2 * torch.randn((1, H, Lp, DH), generator=g, device="cuda")).bfloat16()
    n_in, n_out = L * H * DH * 2, L * H * DH + 4 * L
    want = sf.unfold_quant_wide_plain(planes, L)

    def check(got):
        return {"max_int8_diff": _int8_lsb(got[0], want[0]),
                "scales_bit_equal": bool(torch.equal(got[1], want[1]))}

    _record(args, {"label": args.label, "kernel": "K16", "heads": H, "rows": L, "card": card},
            lambda: sf._unfold_quant_wide_cuda(planes, L), check, n_in + n_out, 0.0)
    del planes, want
    _copy(args, {"label": args.label, "for": f"k16-{L}", "card": card}, n_in + n_out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--draws", type=int, default=1,
                   help="K6 +kv: also the kv sums' worst error on this many draws in all")
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    p.add_argument("--designs", default="",
                   help="with --design: the variants to time (default: all)")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    from turbodiffusion_tpu_torch.ops import sla_fused as sf

    card = kt.card("time_k6_k16")
    print(json.dumps({"label": args.label, "card": card, "ptxas": _ptxas()}), flush=True)
    for case in args.cases.split(","):
        if case.startswith("k6-"):
            _k6(args, card, sf, int(case[3:5]), case.endswith("+kv"))
        elif case == "k16-480p":
            _k16(args, card, sf, L480)
        elif case == "k16-720p":
            _k16(args, card, sf, L720)
        else:
            raise SystemExit(f"time_k6_k16: unknown case {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
