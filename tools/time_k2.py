"""Card time of K1 and K2 (the fused norms of `ops.fused_norm`), with K12 as
the control, at the 1.3B and 14B widths.

Usage:
  python tools/time_k2.py [--root DIR] [--label NAME] [--rows 32760]
      [--kernels k1,k2,k12] [--widths 12x128,40x128] [--rounds 7] [--reps 20]
  python tools/time_k2.py --design [--designs NAME,...] [--kernels k1,k2]

Launches the port's launchers on seeded random bf16 rows of H x Dh
channels (D = H * Dh for K1 / K12) and prints one JSON line per (kernel,
form, width): K1 (`_mln_cuda`) modulated (norm1 / norm2), affine (norm3)
and bare, `F.layer_norm` beside the last two, and a copy of x (`copy_`,
the same bytes read and written: what the card reaches in practice); K12 (`_mln_quant_cuda`,
int8 out) modulated and affine; K2 (`_rmsrope_cuda`) with the rotate-half
RoPE tables and without them (norm only, `F.rms_norm` beside it), on
contiguous rows and on the K column group of a fused (1, rows, 3 x D) QKV
buffer (rows 3 D apart, as `sla` / `original` read q and k). Each line
holds the time a launch takes (CUDA events around `--reps` launches,
`--rounds` rounds: min, median, max), the library call's median where
there is one, the bound (each input read once, each output written once, at
3.35 TB/s) and the share of it the median reaches, the largest difference
from the plain version on the same inputs, the form the launch takes
(`fn.mln_form` / `fn.rmsrope_form`, where the tree has them) and the card's
name and power limit. A width the launcher refuses prints its error.
`--root DIR` imports the package from the checkout at DIR (another tree
unpacked beside this one), so two trees are timed by one script, in
turns, on one card. `--design` times this tree's design variants
(`DESIGNS`): for each, a copy of the package under
`turbodiffusion_tpu_torch/_build/design/<name>` with `csrc/warp_rows.cuh`
(the warp-per-row kernels' shared constants) patched, timed in a process
of its own.
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

# the design variants: (name, [(text of csrc/warp_rows.cuh, its
# replacement), ...]); kMaxVpl, the most 16-byte vectors a lane holds, sets
# the warps a row takes: 8 (this tree) gives a 5120-wide row 4 warps, 12
# gives it 2, 20 gives it 1; kRowThreads is the block of the row kernels;
# kLoadHint / kStoreHint (on in this tree): x's loads skip L1 with 256-byte
# L2 blocks, out's stores stream (evict first)
DESIGNS = [
    ("vpl12", [("constexpr int kMaxVpl = 8;", "constexpr int kMaxVpl = 12;")]),
    ("vpl20", [("constexpr int kMaxVpl = 8;", "constexpr int kMaxVpl = 20;")]),
    ("threads128", [("constexpr int kRowThreads = 256;", "constexpr int kRowThreads = 128;")]),
    ("threads512", [("constexpr int kRowThreads = 256;", "constexpr int kRowThreads = 512;")]),
    ("no-load-hint", [("constexpr bool kLoadHint = true;", "constexpr bool kLoadHint = false;")]),
    ("no-store-hint", [("constexpr bool kStoreHint = true;",
                        "constexpr bool kStoreHint = false;")]),
    ("no-hints", [("constexpr bool kLoadHint = true;", "constexpr bool kLoadHint = false;"),
                  ("constexpr bool kStoreHint = true;", "constexpr bool kStoreHint = false;")]),
]


def _record(args, base: dict, run, plain, nbytes: int, library=None, form=None) -> None:
    """Check `run` against `plain`, time both `run` and `library`, print."""
    import torch
    rec = dict(base)
    try:
        got = run()
    except Exception as e:                      # an older tree's width guard
        print(json.dumps({**rec, "refused": str(e)[:120]}), flush=True)
        return
    want = plain()
    if isinstance(got, tuple):                  # K12: (int8, scales)
        rec["max_int8_diff"] = int((got[0].int() - want[0].int()).abs().max())
        rec["max_scale_rel_err"] = float(((got[1] - want[1]).abs()
                                          / want[1].abs()).max())
    else:
        rec["max_abs_err"] = float((got.float() - want.float()).abs().max())
    del got, want
    torch.cuda.synchronize()
    if form:
        rec["form"] = form
    ms = kt.times(run, args.rounds, args.reps)
    bound = nbytes / HBM * 1e3
    rec.update(ms_min=min(ms), ms_median=statistics.median(ms), ms_max=max(ms),
               bound_ms=bound, share_of_bound=bound / statistics.median(ms))
    if library:
        name, fn_ = library
        rec.update(library=name,
                   library_ms_median=statistics.median(kt.times(fn_, args.rounds,
                                                                args.reps)))
    print(json.dumps(rec), flush=True)


def _k1_k12(args, card: str, fn, kernels) -> None:
    import torch
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    for spec in args.widths.split(","):
        H, Dh = (int(v) for v in spec.split("x"))
        D = H * Dh
        x = (2 * torch.randn((1, args.rows, D), generator=g, device="cuda")).bfloat16()
        ms = 0.1 * torch.randn((1, D), generator=g, device="cuda")
        mb = 0.1 * torch.randn((1, D), generator=g, device="cuda")
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
        n = x.numel()
        forms = {"mod": (ms, mb, None, None, 8 * D),
                 "affine": (None, None, w, bias, 4 * D),
                 "bare": (None, None, None, None, 0)}
        if "k1" in kernels:
            # the practical ceiling: a copy of x, the same bytes read and written
            y = torch.empty_like(x)
            _record(args, {"label": args.label, "kernel": "copy", "mode": "x.copy_",
                           "width": D, "rows": args.rows, "card": card},
                    lambda: y.copy_(x), lambda: x, 4 * n)
            del y
        lib = {"affine": ("F.layer_norm", lambda: F.layer_norm(x, (D,), w, bias, 1e-6)),
               "bare": ("F.layer_norm", lambda: F.layer_norm(x, (D,), eps=1e-6))}
        for name, (a, b, c, d, extra) in forms.items():
            def k1(a=a, b=b, c=c, d=d):
                return fn._mln_cuda(x, a, b, c, d, 1e-6)

            def plain(a=a, b=b, c=c, d=d, q=False):
                return fn.modulated_layer_norm_ref(x, a, b, c, d, 1e-6, quant_out=q)

            form = None
            if hasattr(fn, "mln_form"):
                form = fn.mln_form(D, *(None if t is None else t.data_ptr()
                                        for t in (x, x, a, b, c, d)))
            base = {"label": args.label, "kernel": "K1", "mode": name, "width": D,
                    "rows": args.rows, "card": card}
            if "k1" in kernels:
                _record(args, base, k1, plain, 4 * n + extra, lib.get(name), form)
            if "k12" in kernels and name != "bare":
                _record(args, {**base, "kernel": "K12"},
                        lambda a=a, b=b, c=c, d=d: fn._mln_quant_cuda(x, a, b, c, d, 1e-6),
                        lambda: plain(q=True), 3 * n + 4 * args.rows + extra)
        del x
        torch.cuda.empty_cache()


def _k2(args, card: str, fn) -> None:
    import torch
    F = torch.nn.functional
    F_rms_norm = getattr(F, "rms_norm", None)              # torch >= 2.4
    g = torch.Generator(device="cuda").manual_seed(0)
    for spec in args.widths.split(","):
        H, Dh = (int(v) for v in spec.split("x"))
        HD = H * Dh
        qkv = torch.randn((1, args.rows, 3 * HD), generator=g, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(HD, generator=g, device="cuda")).bfloat16()
        ang = torch.rand((args.rows, Dh // 2), generator=g, device="cuda") * 6.28
        tables = fn.rope_cos_sin_full(ang)
        for layout, x in (("contiguous", qkv[..., HD:2 * HD].contiguous()),
                          ("qkv group", qkv[..., HD:2 * HD])):
            for mode, (cos, sin) in (("rope", tables), ("norm", (None, None))):
                form = None
                if hasattr(fn, "rmsrope_form"):
                    form = fn.rmsrope_form(H, Dh, x.stride(1), *(
                        None if t is None else t.data_ptr() for t in (x, x, w, cos, sin)))
                lib = None
                if mode == "norm" and F_rms_norm:
                    lib = ("F.rms_norm", lambda x=x: F_rms_norm(x, (HD,), w, 1e-6))
                nbytes = 4 * x.numel() + 2 * HD + (0 if cos is None else 8 * cos.numel())
                _record(args, {"label": args.label, "kernel": "K2", "mode": mode,
                               "layout": layout, "width": spec, "rows": args.rows,
                               "card": card},
                        lambda x=x, cos=cos, sin=sin: fn._rmsrope_cuda(x, w, cos, sin,
                                                                       1e-6, H),
                        lambda x=x, cos=cos, sin=sin: fn._rmsrope_plain(x, w, cos, sin,
                                                                        1e-6, H),
                        nbytes, lib, form)
        del qkv
        torch.cuda.empty_cache()


def _design(args) -> int:
    """Each variant of DESIGNS: a copy of the package with the kernel source
    patched, timed in a process of its own."""
    rc = 0
    for name, edits in DESIGNS:
        if args.designs and name not in args.designs.split(","):
            continue
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / "csrc" / "warp_rows.cuh"
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_k2: {name}: text not found once: {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--kernels", args.kernels, "--widths", args.widths, "--rows",
               str(args.rows), "--rounds", str(args.rounds), "--reps", str(args.reps)]
        rc |= subprocess.run(cmd).returncode
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--rows", type=int, default=32760)
    p.add_argument("--kernels", default="k1,k2,k12")
    p.add_argument("--widths", default="12x128,40x128")
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

    card = kt.card("time_k2")
    kernels = args.kernels.split(",")
    if "k1" in kernels or "k12" in kernels:
        _k1_k12(args, card, fn, kernels)
    if "k2" in kernels:
        _k2(args, card, fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
