"""Card time of K23 (the block-sparse attention backward's dq pass) and K24
(its inverse-LUT dk / dv pass) at the training path's shapes.

Usage:
  python tools/time_k23_k24.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 5] [--reps 10]
  python tools/time_k23_k24.py --design [--designs NAME,...] [--cases ...]

Cases (the 1.3B SLA student's self attention at 480p/81f: 32,760 tokens,
12 heads of 128, B 1, top-k 0.1 of `get_block_map` on the random q and k):
  512/256  blocks 512/256, 12 of 128 K blocks (every training path);
  64/64    blocks 64/64, 51 of 512 K blocks (sagesla's straight-through
           backward at --sla_block 64).
q has std 3 and k, v, dO N(0, 1), bf16 from a seeded generator, (B, L, H,
128) contiguous: chip_smoke's phase-2 kinds of inputs.

Each kernel is checked against its plain version (dq, dk, dv at atol 2e-2 +
rtol 2e-2, K23's (lse, delta) at atol 1e-3 + rtol 1e-4: chip_smoke's) and
timed with CUDA events around `--reps` launches, `--rounds` rounds, and
under torch.profiler (`device_ms`: the device time a call spends in the
kernel, by its name in this tree or an older one). One JSON line a kernel
and case: min / median / max ms, device ms, TFLOP/s, the bound (K23: 3
products of 2 x 128 bf16 operations a query-key pair, S, dP and dS K; K24:
4, S^T, dP^T, P^T dO and dS^T q; at the dense peak, or the bytes of inputs
and outputs at 3.35 TB/s, whichever is larger) and the share of it the
kernel reaches, the tile rows the launch took (where the tree names them),
the error, and the card's name and power limit. Each case's line also
carries the dense SDPA backward (dq, dk, dv) of the shape for scale (the
port never calls it) and, for K24, what a static tile schedule (tile t to
block t % grid) would give each block: the most
64-row chunks a block walks over their mean, from the inverse LUT's counts
(arithmetic on the LUT, not a device metric; the kernel takes its tiles
from an atomic counter).
`--root DIR` imports the package from the checkout at DIR (the parent
unpacked with `git archive` into a git-ignored directory such as `_cmp/`),
so two trees are timed by one script, in turns, on one card.

`--design` times this tree's design variants: for each, a copy of the
package under `turbodiffusion_tpu_torch/_build/design/<name>` with
csrc/sparse_attention_bwd.cu patched by the text edits this script carries
(`DESIGNS`), timed by this script with `--root` in a process of its own.
Its lines carry the variant's name.
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

L, DH, HEADS, TOPK = 32760, 128, 12, 0.1
ATOL = RTOL = 2e-2
CASES = {"512/256": (512, 256), "64/64": (64, 64)}
DEFAULT_CASES = "512/256,64/64"
# kernel names this tree and its parent give K23 and K24
NAMES = {"K23": ("kbwd::bwd_kernel<0", "sparse_bwd_dq_kernel"),
         "K24": ("kbwd::bwd_kernel<1", "sparse_bwd_dkv_kernel")}
# the design variants: (name, [(text, replacement)]) in
# csrc/sparse_attention_bwd.cu. `chained`: K23's S and K24's S^T chained
# on the tensor core over all 128 channels; `split24-s<n>` / `split23-s<n>`
# / `split-s<n>`: K24's S^T / K23's S (K24's at the kernel's 2) / both in n
# parts of 128 / n channels, each chained and added in fp32 (the kernel:
# K23 1, K24 2, `kSplitS23`, `kSplitS24`); `stages-<n>`: n chunks in flight
# at 128-row tiles (the kernel: 4)
_SPLIT = "constexpr int kSplitS23 = 1, kSplitS24 = 2;"
_STAGES = "  static constexpr int kStages = ROWS == 128 ? 4 : 2;"
DESIGNS = [(name, [(_SPLIT, f"constexpr int kSplitS23 = {a}, kSplitS24 = {b};")])
           for name, a, b in (("chained", 1, 1), ("split24-s4", 1, 4), ("split24-s8", 1, 8),
                              ("split23-s2", 2, 2), ("split-s8", 8, 8))]
DESIGNS.append(("stages-2", [(_STAGES, "  static constexpr int kStages = 2;")]))

N_SM = 132


def _pairs(lut, bq: int, bk: int) -> int:
    """Query-key pairs of the valid rows and keys these LUT rows select."""
    import torch
    nq = lut.shape[2]
    q_rows = (L - torch.arange(nq, device=lut.device) * bq).clamp(max=bq)
    k_rows = (L - lut.long() * bk).clamp(min=0, max=bk)
    return int((k_rows.sum(-1) * q_rows).sum())


def _schedule(inv, bq: int, bk: int) -> float:
    """The most 64-row query chunks a block of a static K24 schedule would
    walk, over their mean: tile t (of B H ceil(L / rows) in order) goes to block
    (t / streams) % grid, and walks 8 chunks a Q block of its K block's
    inverse-LUT row."""
    import torch
    rows = 128 if bk % 128 == 0 else 64
    streams = 1 if rows == 128 else 2
    n_tiles = -(-L // rows)
    counts = inv[:, :, 0].long()                      # (B H, nK)
    tile_k = torch.arange(n_tiles, device=inv.device) * rows // bk
    chunks = (counts[:, tile_k] * (-(-bq // 64))).flatten()
    items = chunks.numel()
    grid = min(N_SM, -(-items // streams))
    block = (torch.arange(items, device=inv.device) // streams) % grid
    per = torch.zeros(grid, dtype=torch.long, device=inv.device).index_add_(0, block, chunks)
    return float(per.max()) / float(per.float().mean())


def _case(args, base, randn, name: str) -> None:
    import torch
    import torch.nn.functional as F
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    bq, bk = CASES[name]
    q = randn(1, L, HEADS, DH, std=3.0)
    k, v, do = (randn(1, L, HEADS, DH) for _ in range(3))
    scale = DH ** -0.5
    _, lut, sel = get_block_map(q, k, TOPK, bq, bk)
    nK = -(-L // bk)
    inv = sb.inverse_lut(lut, nK)
    pairs = _pairs(lut, bq, bk)
    k23 = lambda: sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk, scale, L)   # noqa: E731
    ld = k23()[1]
    k24 = lambda: sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, bq, bk, scale, L)  # noqa: E731
    io = 2 * 5 * q.numel()            # q, k, v, dO read, one output written (bf16)
    shape = f"{HEADS} heads, {sel}/{nK} blocks {bq}/{bk}"
    qh, kh, vh = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qh, kh, vh)
    sdpa = lambda: torch.autograd.grad(o, (qh, kh, vh), do.transpose(1, 2),  # noqa: E731
                                       retain_graph=True)
    sdpa_ms = statistics.median(kt.times(sdpa, args.rounds, args.reps))
    for kernel, fn, nprod, nbytes in (
            ("K23", k23, 3, io + 8 * ld.shape[0] * L + 4 * lut.numel()),
            ("K24", k24, 4, io + 2 * q.numel() + 8 * ld.shape[0] * L + 4 * inv.numel())):
        ops = nprod * 2 * DH * pairs
        bound = max(ops / PEAK["bf16"], nbytes / HBM) * 1e3
        launcher = sb._sparse_bwd_dq_cuda if kernel == "K23" else sb._sparse_bwd_dkv_cuda
        rec = {**base, "kernel": kernel, "case": name, "shape": shape, "bound_ms": bound}
        try:
            got = fn()
            kt.sync()
            rec["tile_rows"] = getattr(launcher, "last_form", None)
            if kernel == "K23":
                want = sb.sparse_bwd_dq_plain(q, k, v, do, lut, bq, bk, scale, L)
                rec["dq"] = kt.within(got[0], want[0], ATOL, RTOL)
                rec["lse_delta"] = kt.within(got[1][:, :L], want[1][:, :L], 1e-3, 1e-4)
            else:
                want = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, bq, bk, scale, L)
                rec["dk"] = kt.within(got[0], want[0], ATOL, RTOL)
                rec["dv"] = kt.within(got[1], want[1], ATOL, RTOL)
                rec["static_schedule_max_over_mean"] = _schedule(inv, bq, bk)
        except Exception as e:          # a kernel that fails is reported
            print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
            continue
        del got, want
        ms = kt.times(fn, args.rounds, args.reps)
        dev = kt.device_ms(fn, args.reps, NAMES[kernel])
        rec.update({"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
                    "device_ms": dev, "tflops": ops / dev * 1e-9, "bound_share": bound / dev,
                    "sdpa_backward_ms_median": sdpa_ms})
        print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _design(args) -> int:
    """Each variant of DESIGNS: a copy of the package with
    csrc/sparse_attention_bwd.cu patched, timed in a process of its own."""
    rc = 0
    chosen = set(args.designs.split(",")) if args.designs else None
    for name, edits in DESIGNS:
        if chosen is not None and name not in chosen:
            continue
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / "csrc" / "sparse_attention_bwd.cu"
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_k23_k24: {name}: text not found once: {old!r}")
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
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    p.add_argument("--designs", default="", help="with --design: these variants only")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k23_k24")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    base = {"label": args.label, "card": card}
    for name in args.cases.split(","):
        _case(args, base, randn, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
