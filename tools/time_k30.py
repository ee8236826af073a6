"""Card time of K30 (the dense int8-QK flash attention) with K4 and SDPA
beside it on the same q, k, v; of K29 (`subquant_planes`) with K18 beside
it; and of K6 with the linear branch's kv sums at 12 and 40 heads.

Usage:
  python tools/time_k30.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 5] [--reps 5] [--draws 1]
  python tools/time_k30.py --design [--designs NAME,...] [--cases k30]

Cases (seeded random inputs at the 480p shapes; each prints one JSON line):
  * k30: `flash_attention(int8_qk=True)`'s launch (`_flash_i8qk_cuda`) over
    12 heads, 32,760 x 32,760, q, k (smooth-k'd) and v of N(0, 1) bf16;
    beside it on the same tensors K4 (`_flash_cuda`, bf16 QK) and SDPA
    (`scaled_dot_product_attention`, bf16). Its largest difference from
    the plain version (`flash_attention_i8qk_plain`) and whether it is
    within the card tests' atol 2e-2 + rtol 2^-8; the bound: 2 Dh Lq Lk H
    int8 operations at the int8 peak plus as many bf16 at the bf16 peak;
    the device time of the whole call (the int8 rows' launches included)
    and of the attention kernel alone (`walk_device_ms`);
  * k29: `_subquant_planes_cuda` over (1, 12, 32,768, 128) bf16 K planes
    with 32,760 live rows, and K18 (`_subquant_pack_kv_cuda`) on the same
    planes and uniform int8 V; K29's int8 rows against its plain version
    (LSB) and its scales (bit-equal or not); each with its byte bound;
  * k6-12+kv, k6-40+kv: `tools/time_k6_k16.py`'s K6 cases (K planes of
    N(0, 1), uniform int8 V, 256-row blocks): time, device time, the kv
    sums' worst element over rtol / atol 1e-4 of float64
    (`kv_tol_ratio_f64`; with `--draws N` on N - 1 further draws too), the
    launch's blocks and runs.
Times: CUDA events around `--reps` calls, `--rounds` rounds (min, median,
max), and the device time of the call's kernels from torch.profiler; the
card's name and power limit on every line. `--root DIR` imports the
package from the checkout at DIR (the parent unpacked beside this one), so
two trees are timed by one script, in turns, on one card. `--design` times
this tree's K30 variants (`DESIGNS`: its chunk width and ring depth, the
consumers' turns off (or K4's on), other forms of the s32 conversion, the
exp on the FMA pipe, and ablations without the exp or the loads) in copies
of the package under
`turbodiffusion_tpu_torch/_build/design/<name>`, a process each.
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

DH, L, LP, HEADS = 128, 32760, 32768, 12
CASES = ("k30", "k29", "k6-12+kv", "k6-40+kv")

# K30's design variants: (name, [(file under csrc/, its text, the
# replacement), ...]); this tree's chunk is kDenseI8Keys int8 keys in a
# ring of kDenseI8Stages. The "-ablate" variant leaves the SFU's exp2 of
# the scores out (its output is wrong; its time says what the exp costs)
_K30_CHUNK = "constexpr int kDenseI8Keys = 128, kDenseI8Stages = 2;"
_K30_EXP = ("sc[e] = ex2_approx(fmaf(sc[e], (e & 2) ? mul1 : mul0, "
            "(e & 2) ? -mn1 : -mn0));")
# 2^x for x <= 0 on the FMA pipe (ROADMAP item 7's untried idea): x = n + f,
# n = round(x) by the 1.5 2^23 shift, 2^f (|f| <= 1/2) by its degree-3
# Taylor polynomial (relative error <= 8e-4, under bf16 P's half step), 2^n
# added into the exponent; 0 below -125 (as the SFU's flush)
_EX2_FMA = """__device__ __forceinline__ float ex2_fma(float x) {
  const float t = __fadd_rn(fmaxf(x, -125.f), 12582912.f);
  const float f = __fsub_rn(fmaxf(x, -125.f), __fsub_rn(t, 12582912.f));
  const float p = fmaf(fmaf(fmaf(0.0555041087f, f, 0.240226507f), f, 0.693147181f), f, 1.f);
  const int n = __float_as_int(t) - 0x4B400000;
  return x < -125.f ? 0.f : __int_as_float(__float_as_int(p) + (n << 23));
}

"""

# K30's exp2 on the FMA pipe for one score in four of a thread's
_EXP_FMA4 = [("hopper.cuh", "// the max (MAX) or sum of the N / 2 fragment values",
              _EX2_FMA + "// the max (MAX) or sum of the N / 2 fragment values"),
             ("flash_attention.cu", _K30_EXP,
              "{\n        const float x_ = fmaf(sc[e], (e & 2) ? mul1 : mul0, (e & 2) ? -mn1 : -mn0);\n"
              "        sc[e] = (e % 4) == 3 ? ex2_fma(x_) : ex2_approx(x_);\n"
              "      }")]


# the producer loads K, its scales and V for the first ring's worth of
# chunks only and then arrives on the full barriers without a copy: the
# walk's compute without its reads from L2 (K4's too, in that copy)
_NOLOAD = [
    ("flash_attention.cu",
     "            mbar_arrive_expect_tx(kbar, P::kKTile + P::kScaleBytes);\n"
     "            tma_load(&tm_k, kd, kbar, 0, bh * p.Lkp + key0);\n"
     "            bulk_load(scales0(sm) + s * P::kScaleBytes, p.ksc + (size_t)bh * p.Lkp + key0,\n"
     "                      P::kScaleBytes, kbar);\n",
     "            if (c >= kStages) {\n              mbar_arrive(kbar);\n            } else {\n"
     "            mbar_arrive_expect_tx(kbar, P::kKTile + P::kScaleBytes);\n"
     "            tma_load(&tm_k, kd, kbar, 0, bh * p.Lkp + key0);\n"
     "            bulk_load(scales0(sm) + s * P::kScaleBytes, p.ksc + (size_t)bh * p.Lkp + key0,\n"
     "                      P::kScaleBytes, kbar);\n            }\n"),
    ("flash_attention.cu",
     "            mbar_arrive_expect_tx(kbar, P::kKTile);\n"
     "            tma_load_4d(&tm_k, kd, kbar, 0, h, key0, b);\n"
     "            tma_load_4d(&tm_k, kd + P::kKVBox, kbar, 64, h, key0, b);\n",
     "            if (c >= kStages) {\n              mbar_arrive(kbar);\n            } else {\n"
     "            mbar_arrive_expect_tx(kbar, P::kKTile);\n"
     "            tma_load_4d(&tm_k, kd, kbar, 0, h, key0, b);\n"
     "            tma_load_4d(&tm_k, kd + P::kKVBox, kbar, 64, h, key0, b);\n            }\n"),
    ("flash_attention.cu",
     "          mbar_arrive_expect_tx(vbar, 2 * P::kKVBox);\n"
     "          tma_load_4d(&tm_v, vd, vbar, 0, h, key0, b);\n"
     "          tma_load_4d(&tm_v, vd + P::kKVBox, vbar, 64, h, key0, b);\n",
     "          if (c >= kStages) {\n            mbar_arrive(vbar);\n          } else {\n"
     "          mbar_arrive_expect_tx(vbar, 2 * P::kKVBox);\n"
     "          tma_load_4d(&tm_v, vd, vbar, 0, h, key0, b);\n"
     "          tma_load_4d(&tm_v, vd + P::kKVBox, vbar, 64, h, key0, b);\n          }\n"),
]

# s32 -> fp32 and the key's scale in one FFMA: (2^23 1.5 + s) k - fl(2^23
# 1.5 k), off from s k by at most half an ulp of 2^23 1.5 k (s within
# about one unit)
_FUSED_CONV = [("flash_attention.cu", """          sc[4 * j] = s32_float(si[4 * j]) * k2.x;
          sc[4 * j + 1] = s32_float(si[4 * j + 1]) * k2.y;
          sc[4 * j + 2] = s32_float(si[4 * j + 2]) * k2.x;
          sc[4 * j + 3] = s32_float(si[4 * j + 3]) * k2.y;""", """          const float bx = -12582912.f * k2.x, by = -12582912.f * k2.y;
          sc[4 * j] = fmaf(__int_as_float(si[4 * j] + 0x4B400000), k2.x, bx);
          sc[4 * j + 1] = fmaf(__int_as_float(si[4 * j + 1] + 0x4B400000), k2.y, by);
          sc[4 * j + 2] = fmaf(__int_as_float(si[4 * j + 2] + 0x4B400000), k2.x, bx);
          sc[4 * j + 3] = fmaf(__int_as_float(si[4 * j + 3] + 0x4B400000), k2.y, by);""")]

# the consumers' turns (FlashAttention-3's ping-pong) off for K30, or on
# for K4 too
_TURNS = "constexpr bool kTurns = FORM == kDenseI8;"

DESIGNS = [
    ("k30-keys64-s2", [("flash_attention.cu", _K30_CHUNK,
                        "constexpr int kDenseI8Keys = 64, kDenseI8Stages = 2;")]),
    ("k30-keys64-s4", [("flash_attention.cu", _K30_CHUNK,
                        "constexpr int kDenseI8Keys = 64, kDenseI8Stages = 4;")]),
    ("k30-keys128-s3", [("flash_attention.cu", _K30_CHUNK,
                         "constexpr int kDenseI8Keys = 128, kDenseI8Stages = 3;")]),
    ("k30-noexp-ablate", [("flash_attention.cu", _K30_EXP,
                           "sc[e] = fmaf(sc[e], (e & 2) ? mul1 : mul0, (e & 2) ? -mn1 : -mn0);")]),
    ("k30-noload-ablate", _NOLOAD),
    ("k30-noload-noexp-ablate", _NOLOAD + [("flash_attention.cu", _K30_EXP,
                                            "sc[e] = fmaf(sc[e], (e & 2) ? mul1 : mul0, "
                                            "(e & 2) ? -mn1 : -mn0);")]),
    ("k30-fused-conv", _FUSED_CONV),
    ("k30-no-turns", [("flash_attention.cu", _TURNS, "constexpr bool kTurns = false;")]),
    # S's accumulators start at the bits of 1.5 2^23, so that each s32 sum
    # reads as the float 1.5 2^23 + s; the key's scale then in one FFMA
    # with -fl(1.5 2^23 k): no IADD, no FADD a score
    ("k30-s32-init", [
        ("flash_attention.cu", """      } else if constexpr (I8) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(si, sw128_desc(qa + kk * 32), sw128_desc(kb + kk * 32), kk > 0);""",
         """      } else if constexpr (I8) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) si[e] = 0x4B400000;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(si, sw128_desc(qa + kk * 32), sw128_desc(kb + kk * 32), 1);"""),
        ("flash_attention.cu", """          sc[4 * j] = s32_float(si[4 * j]) * k2.x;
          sc[4 * j + 1] = s32_float(si[4 * j + 1]) * k2.y;
          sc[4 * j + 2] = s32_float(si[4 * j + 2]) * k2.x;
          sc[4 * j + 3] = s32_float(si[4 * j + 3]) * k2.y;""", """          const float bx = -12582912.f * k2.x, by = -12582912.f * k2.y;
          sc[4 * j] = fmaf(__int_as_float(si[4 * j]), k2.x, bx);
          sc[4 * j + 1] = fmaf(__int_as_float(si[4 * j + 1]), k2.y, by);
          sc[4 * j + 2] = fmaf(__int_as_float(si[4 * j + 2]), k2.x, bx);
          sc[4 * j + 3] = fmaf(__int_as_float(si[4 * j + 3]), k2.y, by);""")]),
    # S's s32 sums in the float array's registers (the wgmma writes sc
    # reinterpreted as int), converted in place: 64 registers fewer
    ("k30-inplace", [
        ("flash_attention.cu", """      } else if constexpr (I8) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(si, sw128_desc(qa + kk * 32), sw128_desc(kb + kk * 32), kk > 0);""",
         """      } else if constexpr (I8) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(reinterpret_cast<int*>(sc), sw128_desc(qa + kk * 32),
                   sw128_desc(kb + kk * 32), kk > 0);"""),
        ("flash_attention.cu", """        reg_fence<kKeys / 2>(si);
        const float* ks = reinterpret_cast<const float*>(""", """        reg_fence<kKeys / 2>(sc);
        const float* ks = reinterpret_cast<const float*>("""),
        ("flash_attention.cu", """          sc[4 * j] = s32_float(si[4 * j]) * k2.x;
          sc[4 * j + 1] = s32_float(si[4 * j + 1]) * k2.y;
          sc[4 * j + 2] = s32_float(si[4 * j + 2]) * k2.x;
          sc[4 * j + 3] = s32_float(si[4 * j + 3]) * k2.y;""", """          sc[4 * j] = s32_float(__float_as_int(sc[4 * j])) * k2.x;
          sc[4 * j + 1] = s32_float(__float_as_int(sc[4 * j + 1])) * k2.y;
          sc[4 * j + 2] = s32_float(__float_as_int(sc[4 * j + 2])) * k2.x;
          sc[4 * j + 3] = s32_float(__float_as_int(sc[4 * j + 3])) * k2.y;""")]),
    ("k4-turns", [("flash_attention.cu", _TURNS,
                   "constexpr bool kTurns = FORM == kDenseI8 || FORM == kDense;")]),
    ("k30-exp-fma4", _EXP_FMA4),
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
                raise SystemExit(f"time_k30: {name}: text not found once: {old!r}")
            path.write_text(text.replace(old, new))
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--cases", args.cases, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        rc |= subprocess.run(cmd).returncode
    return rc


def _ptxas() -> str:
    """ptxas's line for each attention kernel of flash_attention.cu this
    process built (registers, stack, spills, C7514), as chip_smoke's phase 1
    prints them."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from turbodiffusion_tpu_torch.ops import _build
    return "; ".join(k for k in chip_smoke._ptxas_summary(_build.load().build_log).split("; ")
                     if k.startswith(("k4::flash_fwd_kernel", "flash_i8qk_kernel",
                                      "i8qk_quant_kernel")))


def _timed(args, fn, keys=("",)) -> dict:
    """Event times (min, median, max) and the device time of fn's kernels
    whose name holds one of `keys`."""
    ms = kt.times(fn, args.rounds, args.reps)
    return {"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
            "device_ms": kt.device_ms(fn, args.reps, keys)}


def _k30(args, base: dict) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(30)
    q, k, v = (torch.randn((1, L, HEADS, DH), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    k = k - k.mean(dim=1, keepdim=True)
    scale = DH ** -0.5
    pairs = L * L * HEADS
    bound = (2 * DH * pairs / PEAK["int8"] + 2 * DH * pairs / PEAK["bf16"]) * 1e3
    kern = lambda: fa._flash_i8qk_cuda(q, k, v, scale, L)      # noqa: E731
    rec = {**base, "kernel": "K30", "shape": f"{HEADS} heads, dense {L}x{L}",
           "bound_ms": bound}
    try:
        got = kern()
        kt.sync()
        rec.update(kt.within(got, fa.flash_attention_i8qk_plain(q, k, v, scale, L),
                             2e-2, 2.0 ** -8))
        rec["bit_equal_rerun"] = bool(torch.equal(kern(), got))
        del got
    except Exception as e:          # a kernel that fails is reported
        print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
        return
    rec.update(_timed(args, kern))
    rec["walk_device_ms"] = kt.device_ms(kern, args.reps,
                                         ("flash_fwd_kernel", "flash_i8qk_kernel"))
    rec["device_share_of_bound"] = bound / rec["device_ms"]
    k4 = _timed(args, lambda: fa._flash_cuda(q, k, v, scale, L))
    rec.update({f"k4_{key}": val for key, val in k4.items()})
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = _timed(args, lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale))
    rec.update({f"sdpa_{key}": val for key, val in sdpa.items()})
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _k29(args, base: dict) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    g = torch.Generator(device="cuda").manual_seed(29)
    k = torch.randn((1, HEADS, LP, DH), generator=g, device="cuda").bfloat16()
    k[:, :, L:] = 0
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi = torch.randint(-127, 128, (1, HEADS, LP, DH), generator=g, device="cuda",
                       dtype=torch.int8)
    n = HEADS * LP * DH
    got, want = sf._subquant_planes_cuda(k, mu), sf.subquant_planes_plain(k, mu)
    bound = (2 * n + n + 4 * HEADS * LP) / HBM * 1e3
    rec = {**base, "kernel": "K29", "shape": f"{HEADS}x{LP}x{DH}",
           "max_int8_diff": int((got[0].int() - want[0].int()).abs().max()),
           "scales_bit_equal": bool(torch.equal(got[1], want[1])), "bound_ms": bound}
    del got, want
    rec.update(_timed(args, lambda: sf._subquant_planes_cuda(k, mu)))
    rec["device_share_of_bound"] = bound / rec["device_ms"]
    k18_bound = (2 * n + n + 2 * n + 4 * HEADS * LP) / HBM * 1e3
    k18 = _timed(args, lambda: sf._subquant_pack_kv_cuda(k, mu, vi))
    rec.update({f"k18_{key}": val for key, val in k18.items()})
    rec.update(k18_bound_ms=k18_bound, k18_device_share_of_bound=k18_bound / k18["device_ms"])
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--draws", type=int, default=1,
                   help="K6: also the kv sums' worst error on this many draws in all")
    p.add_argument("--design", action="store_true", help="time this tree's K30 variants")
    p.add_argument("--designs", default="",
                   help="with --design: the variants to time (default: all)")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import time_k6_k16
    from turbodiffusion_tpu_torch.ops import sla_fused as sf

    card = kt.card("time_k30")
    base = {"label": args.label, "card": card}
    print(json.dumps({**base, "ptxas": _ptxas()}), flush=True)
    for case in args.cases.split(","):
        if case == "k30":
            _k30(args, base)
        elif case == "k29":
            _k29(args, base)
        elif case in ("k6-12+kv", "k6-40+kv"):
            time_k6_k16._k6(args, card, sf, int(case[3:5]), True)
        else:
            raise SystemExit(f"time_k30: unknown case {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
