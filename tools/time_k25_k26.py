"""Card time of K25 (dense forward-mode attention) and K26 (its block-sparse
form) at the main path's shapes.

Usage:
  python tools/time_k25_k26.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 5] [--reps 10] [--f64]
  python tools/time_k25_k26.py --design [--cases ...]

Cases (the 1.3B rCM student's calls at 480p/81f: 32,760 tokens, 12 heads of
128, B 1):
  self     K25 over 32,760 x 32,760 (the dense student's self attention);
  cross    K25 over 32,760 x 512 (every student's cross attention);
  k26      K26 at blocks 512/256, 12 of the 128 K blocks a Q block
           (`get_block_map` at top-k 0.1 on the random q and k: the sla
           student's self attention);
  k26-64   K26 at blocks 64/64 (51 of 512 K blocks), the mma.sync form,
           which no default path runs (an sla student given 64/64 blocks
           through the model.attention overrides does; not in the default
           cases).
q has std 3 and k, v and the three tangents N(0, 1), bf16 from a seeded
generator, (B, L, H, 128) contiguous: chip_smoke's phase-2 inputs.

Each kernel is checked against its plain version (atol 0.1 + rtol 2e-2,
chip_smoke's JVP_ATOL) and timed with CUDA events around `--reps` launches,
`--rounds` rounds, and under torch.profiler (`device_ms`: the device time a
call spends in the kernel, by its name in this tree or an older one). One
JSON line a case: min / median / max ms, device ms, TFLOP/s, the bound
(12 x 128 bf16 operations a query-key pair at the dense peak, or the bytes
of the inputs and outputs at 3.35 TB/s, whichever is larger) and the share
of it the kernel reaches, the form the launch took (where the tree names
it), the error, `F.scaled_dot_product_attention`'s forward on the same q, k,
v for scale (no PyTorch call computes an attention JVP; the port never calls
it), and the card's name and power limit. With `--f64`, on the 16 query
rows where the kernel's do lies farthest from its plain version's, both are
held against float64 (exact sums, unrounded P): the worst |error| of each,
o and do. `--root DIR` imports the package from the checkout at DIR (the
parent unpacked with `git archive` into a git-ignored directory such as
`_cmp/`), so two trees are timed by one script, in turns, on one card.

`--design` times this tree's design variants: for each, a copy of the
package under `turbodiffusion_tpu_torch/_build/design/<name>` with
csrc/flash_jvp.cu patched by the text edits this script carries (`DESIGNS`:
"overlap", FA3's intra-warpgroup order), timed by this script with `--root`
in a process of its own. Its lines carry the variant's name.
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

L, TEXT, DH, HEADS, TOPK = 32760, 512, 128, 12, 0.1
JVP_ATOL, JVP_RTOL = 0.1, 2e-2
# name: (keys, blocks (None: dense))
CASES = {"self": (L, None), "cross": (TEXT, None), "k26": (L, (512, 256)),
         "k26-64": (L, (64, 64))}
DEFAULT_CASES = "self,cross,k26"
# kernel names this tree and its parent give K25 and K26
KERNEL_NAMES = ("jvp_fwd_kernel", "sparse_jvp_mma_kernel", "flash_jvp_kernel")
# FA3's intra-warpgroup order in k25::jvp_fwd_kernel's consumer loop: S
# issued with the previous chunk's P products (`prev`, the stage whose
# products are pending), the row max and exp2 under them, then dS with bf16(P)
# packed under it; the last chunk's products after the loop. The kernel's own
# order: S and dS together, the softmax, the same chunk's P products.
_PREV_PV = """mbar_wait(vfull0 + 8 * prev, ((c - 1) / kStages) & 1);
      issue_pv(st0 + prev * kStage + 2 * kKVTile);"""
_OVERLAP = [
    ("    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, mu0 = 0.f, mu1 = 0.f;\n",
     "    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, mu0 = 0.f, mu1 = 0.f;\n"
     "    int prev = -1;\n"),
    ("""      issue_s(kb);
      issue_ds(kb);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<32>(sc);
      reg_fence<32>(ds);
      if (lt == 0) mbar_arrive(kempty0 + 8 * s);   // K and dK are read
""", f"""      issue_s(kb);
      wgmma_commit();
      if (prev >= 0) {{
        {_PREV_PV.replace(chr(10), chr(10) + "  ")}
        wgmma_wait<1>();
      }} else {{
        wgmma_wait<0>();
      }}
      reg_fence<32>(sc);
"""),
    ("      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {\n",
     """      wgmma_wait<0>();
      fence_pv();
      if (prev >= 0 && lt == 0) mbar_arrive(vempty0 + 8 * prev);
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {\n"""),
    ("""#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
""", """      reg_fence<32>(sc);
      wgmma_fence();
      issue_ds(kb);
      wgmma_commit();
#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      wgmma_wait<0>();
      reg_fence<32>(ds);
      if (lt == 0) mbar_arrive(kempty0 + 8 * s);
"""),
    ("""      fence_pv();
      wgmma_fence();
      mbar_wait(vfull0 + 8 * s, (c / kStages) & 1);
      issue_pv(kb + 2 * kKVTile);
      wgmma_wait<0>();
      fence_pv();
      if (lt == 0) mbar_arrive(vempty0 + 8 * s);
    }
""", f"""      prev = s;
    }}
    if (prev >= 0) {{
      fence_pv();
      wgmma_fence();
      {_PREV_PV}
      wgmma_wait<0>();
      fence_pv();
      if (lt == 0) mbar_arrive(vempty0 + 8 * prev);
    }}
"""),
]
# the design variants: (name, [(text, replacement)]) in csrc/flash_jvp.cu
DESIGNS = [("overlap", _OVERLAP)]


def _pairs(lut, bq: int, bk: int, lq: int = L, kv_len: int = L) -> int:
    """Query-key pairs of the valid rows and keys these LUT rows select."""
    import torch
    nq = lut.shape[2]
    q_rows = (lq - torch.arange(nq, device=lut.device) * bq).clamp(max=bq)
    k_rows = (kv_len - lut.long() * bk).clamp(min=0, max=bk)
    return int((k_rows.sum(-1) * q_rows).sum())


def _f64_rows(q, k, v, dq, dk, dv, rows, lut=None, bq=None, bk=None):
    """(o, do) of batch 0 at query `rows`, every head, in float64 (the
    selected K blocks of each row's Q block where a LUT is given)."""
    import torch
    scale = DH ** -0.5
    f = lambda t: t[0].double().transpose(0, 1)                 # noqa: E731
    qh, dqh = f(q[:, rows]), f(dq[:, rows])
    kh, vh, dkh, dvh = (f(t) for t in (k, v, dk, dv))
    s = qh @ kh.transpose(-1, -2) * scale
    ds = (dqh @ kh.transpose(-1, -2) + qh @ dkh.transpose(-1, -2)) * scale
    if lut is not None:
        nk = -(-k.shape[1] // bk)
        allowed = torch.zeros((HEADS, len(rows), nk), dtype=torch.bool, device=q.device)
        allowed.scatter_(-1, lut[0][:, rows // bq].long(), True)
        live = allowed[..., torch.arange(k.shape[1], device=q.device) // bk]
        s = torch.where(live, s, float("-inf"))
        ds = torch.where(live, ds, 0.0)
    p = torch.softmax(s, -1)
    mu = (p * ds).sum(-1, keepdim=True)
    o = p @ vh
    do = (p * (ds - mu)) @ vh + p @ dvh
    return o.transpose(0, 1), do.transpose(0, 1)


def _case(args, base, randn, name: str) -> None:
    import torch
    import torch.nn.functional as F
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    lk, blocks = CASES[name]
    q, dq = randn(1, L, HEADS, DH, std=3.0), randn(1, L, HEADS, DH)
    k, v, dk, dv = (randn(1, lk, HEADS, DH) for _ in range(4))
    scale = DH ** -0.5
    form_fn = getattr(fj, "jvp_form", None)       # a tree without it: None
    st = fa._strides(q, k, v, dq, dk, dv)
    if blocks is None:
        lut = None
        kern = lambda: fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, lk)   # noqa: E731
        plain = lambda: fj.flash_attention_jvp_plain(q, k, v, dq, dk, dv,   # noqa: E731
                                                     scale, lk)
        pairs, shape = L * lk, f"{HEADS} heads, {L} x {lk}"
        form = form_fn(0, 0, lk, *st) if form_fn else None
    else:
        bq, bk = blocks
        _, lut, sel = get_block_map(q, k, TOPK, bq, bk)
        kern = lambda: fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut, bq, bk,  # noqa
                                                 scale, L)
        plain = lambda: fj.sparse_flash_attention_jvp_plain(q, k, v, dq, dk, dv, lut,  # noqa
                                                            bq, bk, scale, L)
        pairs, shape = _pairs(lut, bq, bk), f"{HEADS} heads, {sel}/{-(-L // bk)} blocks {bq}/{bk}"
        form = form_fn(bq, bk, L, *st) if form_fn else None
    ops = 12 * DH * pairs * (HEADS if blocks is None else 1)
    nbytes = 2 * sum(t.numel() for t in (q, k, v, dq, dk, dv)) + 2 * 2 * q.numel()
    bound = max(ops / PEAK["bf16"], nbytes / HBM) * 1e3
    rec = {**base, "kernel": "K25" if blocks is None else "K26", "case": name,
           "shape": shape, "form": form, "bound_ms": bound}
    try:
        got = kern()
        kt.sync()
        want = plain()
        rec["o"] = kt.within(got[0], want[0], JVP_ATOL, JVP_RTOL)
        rec["do"] = kt.within(got[1], want[1], JVP_ATOL, JVP_RTOL)
        if args.f64:
            rows = (got[1].float() - want[1].float()).abs().amax((0, 2, 3)).topk(16).indices
            refs = _f64_rows(q, k, v, dq, dk, dv, rows, lut, *(blocks or (None, None)))
            rec["f64_worst_rows"] = {
                nm: {"kernel": float((g[0, rows].double() - r).abs().max()),
                     "plain": float((w[0, rows].double() - r).abs().max()),
                     "ref_abs_max": float(r.abs().max())}
                for nm, g, w, r in zip(("o", "do"), got, want, refs)}
    except Exception as e:          # a kernel that fails is reported
        print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
        return
    del got, want
    ms = kt.times(kern, args.rounds, args.reps)
    dev = kt.device_ms(kern, args.reps, KERNEL_NAMES)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)   # noqa: E731
    rec.update({"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
                "device_ms": dev, "tflops": ops / dev * 1e-9,
                "bound_share": bound / dev,
                "sdpa_forward_ms_median": statistics.median(kt.times(sdpa, args.rounds,
                                                                     args.reps))})
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _design(args) -> int:
    """Each variant of DESIGNS: a copy of the package with csrc/flash_jvp.cu
    patched, timed in a process of its own."""
    rc = 0
    for name, edits in DESIGNS:
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / "csrc" / "flash_jvp.cu"
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_k25_k26: {name}: text not found once: {old!r}")
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
    p.add_argument("--cases", default=DEFAULT_CASES)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--f64", action="store_true",
                   help="hold kernel and plain version against float64 on the worst rows")
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k25_k26")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    base = {"label": args.label, "card": card}
    for name in args.cases.split(","):
        _case(args, base, randn, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
