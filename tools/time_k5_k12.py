"""Card time of K5 (`head_planes`, the SageSLA head-plane pass) and K12 (the
int8-out modulated LayerNorm), with K1 and a copy of the same bytes beside
them, at the 1.3B and 14B widths.

Usage:
  python tools/time_k5_k12.py [--root DIR] [--label NAME] [--rows 32760]
      [--kernels k5,k12,k1] [--heads 12,40] [--rounds 7] [--reps 20]
  python tools/time_k5_k12.py --design [--designs NAME,...] [--kernels k5,k12]

Launches the port's launchers on seeded random bf16 rows and prints one
JSON line per case:
  * K5 (`_head_planes_cuda`) at 12 and 40 heads of 128 on `--rows` rows
    padded to a multiple of 512, in the fused path's passes: Q (RMSNorm +
    RoPE, int8 with per-(head, row) scales, means pooled over 512 rows), K
    (bf16 planes, pooled over 256), V (bf16 planes) and V at v_quant "row"
    (int8). Above 16 heads the Q and K passes run three ways: with the
    row's RMS taken in K5 ("own RMS": this tree's path; an older tree's
    launcher refuses it), as the pair K15 (`_row_rms_inv_cuda`) then K5
    reading its statistic ("K15 + K5": the older tree's path), and K5 alone
    reading a statistic computed before ("external RMS");
  * K12 (`_mln_quant_cuda`) modulated (norm1 / norm2) and affine (norm3) at
    widths 1536 and 5120 (12 and 40 heads of 128);
  * K1 (`_mln_cuda`) modulated, and a copy of x (`copy_`, the same bytes
    read and written: what the card reaches in practice).
Each line holds the time a call takes (CUDA events around `--reps` calls,
`--rounds` rounds: min, median, max), the device time of the call's
kernels from torch.profiler (the wrapper's host time left out), the bound
(each input read once, each output written once, at 3.35 TB/s; the K15 +
K5 pair computes the same function as K5 alone and has its bound) and the
share of it the median reaches, the largest difference from the plain
version on the same inputs, the form the launch takes
(`sf.head_planes_form` / `fn.mln_quant_form` / `fn.mln_form`, where the
tree has them) and the card's name and power limit. A case the launcher
refuses prints its error. `--root DIR` imports the package from the
checkout at DIR (another tree unpacked beside this one), so two trees are
timed by one script, in turns, on one card. `--design` times this tree's
design variants (`DESIGNS`): for each, a copy of the package under
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
from kernel_timing import HBM, ROOT

DH = 128
# K5's passes on the fused path: (pool, int8 planes, bf16 planes, norm +
# RoPE)
K5_PASSES = {"Q": (512, True, False, True), "K": (256, False, True, True),
             "V": (0, False, True, False), "V row": (0, True, False, False)}


# the design variants: (name, [(file under csrc/, its text, the
# replacement), ...]). kQuantPrefetch: a K12 warp's next row in flight
# (cp.async into shared memory) while it works on its row (this tree: on);
# kHpMinBlocks / kQuantMinBlocks: the blocks an SM
# K5's and K12's path instances are compiled for (this tree: 2, at most
# 128 registers); "k12-hold": K12 keeps its fp32 values from the absmax pass
# to the quantise, where this tree recomputes them from the packed row. The
# "-ablate" variants leave a piece of work out (their outputs are wrong;
# their times say what the piece costs): K5's int8 scale reciprocal (the
# SFU's estimate in place of rcp_rn), its pooled sums, its quantise
_K12_BARRIER = ('asm volatile("" : "+r"(v[i].x), "+r"(v[i].y), "+r"(v[i].z), '
                '"+r"(v[i].w)::"memory");')
DESIGNS = [
    ("k12-noprefetch", [("fused_norm.cu", "constexpr bool kQuantPrefetch = true;",
                         "constexpr bool kQuantPrefetch = false;")]),
    ("k5-min3", [("sla_fused.cu", "constexpr int kHpMinBlocks = 2;",
                  "constexpr int kHpMinBlocks = 3;")]),
    ("k12-min1", [("fused_norm.cu", "constexpr int kQuantMinBlocks = 2;",
                   "constexpr int kQuantMinBlocks = 1;")]),
    ("k12-hold", [("fused_norm.cu", _K12_BARRIER, ";")]),
    ("k12-hold-min1", [("fused_norm.cu", _K12_BARRIER, ";"),
                       ("fused_norm.cu", "constexpr int kQuantMinBlocks = 2;",
                        "constexpr int kQuantMinBlocks = 1;")]),
    ("k5-rcp-ablate", [("sla_fused.cu", "quant8_rn(y, rcp_rn(scale))",
                        "quant8_rn(y, __fdividef(1.f, scale))")]),
    ("k5-pool-ablate", [("sla_fused.cu", "if (pool && valid && live) {",
                         "if (false) {")]),
    ("k5-quant-ablate", [("sla_fused.cu", "quant8_rn(y, rcp_rn(scale))",
                          "make_uint2(__float_as_uint(y[0]), __float_as_uint(scale))")]),
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
                raise SystemExit(f"time_k5_k12: {name}: text not found once: {old!r}")
            path.write_text(text.replace(old, new))
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--kernels", args.kernels, "--heads", args.heads, "--rows", str(args.rows),
               "--rounds", str(args.rounds), "--reps", str(args.reps)]
        rc |= subprocess.run(cmd).returncode
    return rc


def _ptxas() -> dict:
    """ptxas's registers, stack frame and spill stores of K5's and K12's
    path instances (VPL 5 and 6), when this process built the library (else
    empty)."""
    import re
    from turbodiffusion_tpu_torch.ops import _build
    out, name = {}, None
    for ln in _build.load().build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*(head_planes_rows_kernel|mln_rows_kernel)"
                      r"ILi([56])E(Lb1E)?", ln)
        if m:
            name = None
            if m.group(1).startswith("head"):
                name = f"K5<{m.group(2)}>"
            elif m.group(3):
                name = f"K12<{m.group(2)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} B stack, {m.group(2)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
            name = None
    return out


def _diff(got, want) -> dict:
    """The largest difference of each output: int8 in LSB, fp32 scales
    relative, the rest absolute."""
    import torch
    if isinstance(got, dict):
        out = {}
        for key in sorted(want):
            out.update({f"{key}_{k}": v for k, v in _diff(got[key], want[key]).items()})
        return out
    if isinstance(got, tuple):                  # K12: (int8, scales)
        return {"max_int8_diff": int((got[0].int() - want[0].int()).abs().max()),
                "max_scale_rel_err": float(((got[1] - want[1]).abs()
                                            / want[1].abs()).max())}
    if got.dtype == torch.int8:
        return {"max_int8_diff": int((got.int() - want.int()).abs().max())}
    return {"max_abs_err": float((got.float() - want.float()).abs().max())}


def _record(args, base: dict, run, plain, nbytes: int, keys: tuple, form=None) -> None:
    """Check `run` against `plain`, time `run`, print one line."""
    import torch
    rec = dict(base)
    try:
        got = run()
    except Exception as e:                      # an older tree's refusal
        print(json.dumps({**rec, "refused": str(e)[:160]}), flush=True)
        return
    rec.update(_diff(got, plain()))
    del got
    torch.cuda.synchronize()
    if form:
        rec["form"] = form
    ms = kt.times(run, args.rounds, args.reps)
    bound = nbytes / HBM * 1e3
    rec.update(ms_min=min(ms), ms_median=statistics.median(ms), ms_max=max(ms),
               device_ms=kt.device_ms(run, args.reps, keys), bound_ms=bound,
               share_of_bound=bound / statistics.median(ms))
    rec["device_share_of_bound"] = bound / rec["device_ms"]
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _k5_bytes(L: int, Lp: int, H: int, pool: int, quant: bool, bf16: bool,
              norm: bool) -> int:
    n = L * H * DH
    b = 2 * n + (2 * H * DH + 2 * 4 * L * DH if norm else 0)
    b += 2 * H * Lp * DH if bf16 else 0
    b += H * Lp * DH + 4 * H * Lp if quant else 0
    b += 4 * H * (-(-L // pool)) * DH if pool else 0
    return b


def _k5(args, card: str, sf, fn) -> None:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    L = args.rows
    Lp = -(-L // 512) * 512
    ang = torch.rand((L, DH // 2), generator=g, device="cuda") * 6.28
    cos, sin = fn.rope_cos_sin_full(ang)
    for H in (int(h) for h in args.heads.split(",")):
        HD = H * DH
        x = torch.randn((1, L, HD), generator=g, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(HD, generator=g, device="cuda")).bfloat16()
        ri = sf.row_rms_inv_plain(x, 1e-6)
        for name, (pool, quant, bf16, norm) in K5_PASSES.items():
            args_k5 = (w, cos, sin) if norm else (None, None, None)
            kw = dict(weight=args_k5[0], cos_full=args_k5[1], sin_full=args_k5[2],
                      pool=pool, quant=quant, bf16_out=bf16)
            form = None
            if hasattr(sf, "head_planes_form"):
                form = sf.head_planes_form(H, HD, *(None if t is None else t.data_ptr()
                                                    for t in (x, *args_k5)), None, None, None)
            nbytes = _k5_bytes(L, Lp, H, pool, quant, bf16, norm)
            base = {"label": args.label, "kernel": "K5", "pass": name, "heads": H,
                    "rows": L, "card": card}

            def own(a=args_k5, pool=pool, quant=quant, bf16=bf16):
                return sf._head_planes_cuda(x, *a, H, 1e-6, pool, quant, bf16, Lp)

            def plain(kw=kw, ri_=None):
                return sf.head_planes_plain(x, num_heads=H, eps=1e-6, pad_to=Lp,
                                            rms_inv=ri_, **kw)

            _record(args, {**base, "mode": "own RMS" if norm else "no norm"}, own, plain,
                    nbytes, ("head_planes",), form)
            if not norm or HD <= 4096:
                continue

            def pair(a=args_k5, pool=pool, quant=quant, bf16=bf16):
                r = sf._row_rms_inv_cuda(x, 1e-6, None, 0)
                return sf._head_planes_cuda(x, *a, H, 1e-6, pool, quant, bf16, Lp, r)

            def ext(a=args_k5, pool=pool, quant=quant, bf16=bf16):
                return sf._head_planes_cuda(x, *a, H, 1e-6, pool, quant, bf16, Lp, ri)

            _record(args, {**base, "mode": "K15 + K5"}, pair,
                    lambda kw=kw: plain(kw, ri), nbytes, ("head_planes", "row_rms_inv"),
                    form)
            _record(args, {**base, "mode": "external RMS"}, ext,
                    lambda kw=kw: plain(kw, ri), nbytes + 4 * L, ("head_planes",), form)
        del x, ri
        torch.cuda.empty_cache()


def _k12_k1(args, card: str, fn, kernels) -> None:
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    L = args.rows
    for H in (int(h) for h in args.heads.split(",")):
        D = H * DH
        x = (2 * torch.randn((1, L, D), generator=g, device="cuda")).bfloat16()
        ms = 0.1 * torch.randn((1, D), generator=g, device="cuda")
        mb = 0.1 * torch.randn((1, D), generator=g, device="cuda")
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
        n = x.numel()
        base = {"label": args.label, "width": D, "rows": L, "card": card}
        for mode, (a, b, c, d, extra) in (("mod", (ms, mb, None, None, 8 * D)),
                                          ("affine", (None, None, w, bias, 4 * D))):
            ptrs = [None if t is None else t.data_ptr() for t in (x, x, a, b, c, d)]
            if "k12" in kernels:
                form = fn.mln_quant_form(D, *ptrs) if hasattr(fn, "mln_quant_form") else None
                _record(args, {**base, "kernel": "K12", "mode": mode},
                        lambda a=a, b=b, c=c, d=d: fn._mln_quant_cuda(x, a, b, c, d, 1e-6),
                        lambda a=a, b=b, c=c, d=d: fn.modulated_layer_norm_ref(
                            x, a, b, c, d, 1e-6, quant_out=True),
                        3 * n + 4 * L + extra, ("mln_",), form)
            if "k1" in kernels and mode == "mod":
                _record(args, {**base, "kernel": "K1", "mode": mode},
                        lambda a=a, b=b: fn._mln_cuda(x, a, b, None, None, 1e-6),
                        lambda a=a, b=b: fn.modulated_layer_norm_ref(x, a, b, None, None,
                                                                     1e-6),
                        4 * n + extra, ("mln_",), fn.mln_form(D, *ptrs))
        if "k1" in kernels:
            y = torch.empty_like(x)
            _record(args, {**base, "kernel": "copy", "mode": "x.copy_"},
                    lambda: y.copy_(x), lambda: x, 4 * n, ("",))
            del y
        del x
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--rows", type=int, default=32760)
    p.add_argument("--kernels", default="k5,k12,k1")
    p.add_argument("--heads", default="12,40")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    p.add_argument("--designs", default="",
                   help="with --design: the variants to time (default: all)")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf

    card = kt.card("time_k5_k12")
    print(json.dumps({"label": args.label, "card": card, "ptxas": _ptxas()}), flush=True)
    kernels = args.kernels.split(",")
    if "k5" in kernels:
        _k5(args, card, sf, fn)
    if "k12" in kernels or "k1" in kernels:
        _k12_k1(args, card, fn, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
