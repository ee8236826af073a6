"""Card time of K19 (int8 SageSLA attention with per-row scales, `--v_quant
row`) and K20 (the int8-QK sparse gather, `--sla_block 64`) at the main
path's shapes.

Usage:
  python tools/time_k19_k20.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 7] [--reps 20] [--check]

Cases (480p/81f: 32,760 tokens, heads of 128):
  k19-1.3b   K19 as fused sagesla at --v_quant row calls it: blocks 512/256,
             12 of the 128 K blocks a Q block (`get_block_map` at top-k 0.1
             on the random q and k), 12 heads, 32,768 padded rows; int8 q
             with row scales, K18's packed K|V rows and K row scales,
             per-row int8 V and V row scales, from their plain versions;
  k20-1.3b   K20 as sagesla at --sla_block 64 calls it: blocks 64/64, 51 of
             512 K blocks a Q block, 12 heads, bf16 q, smooth-k'd k and v
             (B, L, H, D); K3 on the same LUT and operands timed beside it;
  k30-1.3b   K30 (no path reaches it; it shares K20's first launch) over
             every key: dense int8-QK self attention, 12 heads, 32,760 x
             32,760.
q, k, v (and K19's planes) are N(0, 1) bf16 from a seeded generator, as
chip_smoke's phase-2 checks of K19 and K20 take them (on a sharper q an
online softmax that rounds P to bf16 at a running max lands up to ~0.016
from the one-pass plain version on a few outputs).

Each kernel is checked against its plain version (atol 4e-3 + rtol 2e-2;
K30 atol 2e-2 + rtol 2e-2, chip_smoke's)
and timed with CUDA events around `--reps` launches, `--rounds` rounds, and
under torch.profiler (`device_ms`: the device time a call spends in the
kernel's launches, K20's first launches that quantise q and k included;
`walk_device_ms`: the main launch alone). One JSON line a case: min /
median / max ms, device ms, the form the launch took (where the package
names it), the bound (the query-key pairs these inputs need, QK at the int8
and P V at the bf16 dense peak, or the bytes of the inputs and the output at
3.35 TB/s, whichever is larger), the bytes the gather reads from L2 (each
chunk's K, V and scales, once for every tile that walks it), the error, and
the card's name and power limit. `--check` checks and times nothing else.
`--root DIR` imports the package from the checkout at DIR, so two trees are
timed by one script, in turns, on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import kernel_timing as kt
from kernel_timing import HBM, PEAK

L, LP, DH, HEADS = 32760, 32768, 128, 12
# name: (block_q, block_k, top-k ratio)
CASES = {"k19-1.3b": (512, 256, 0.1), "k20-1.3b": (64, 64, 0.1), "k30-1.3b": (0, 0, 1.0)}


def _pairs(lut, block_q: int, block_k: int, lq: int = L, kv_len: int = L) -> int:
    """Query-key pairs of the valid rows and keys these LUT rows select."""
    import torch
    nq = lut.shape[2]
    q_rows = (lq - torch.arange(nq, device=lut.device) * block_q).clamp(max=block_q)
    k_rows = (kv_len - lut.long() * block_k).clamp(min=0, max=block_k)
    return int((k_rows.sum(-1) * q_rows).sum())


def _gather_bytes(lut, block_q: int, block_k: int, tile: int, chunk: int,
                  chunk_bytes: int, lq: int = L, kv_len: int = L) -> int:
    """Bytes the walk reads: every `tile`-row tile of a Q block reads each
    `chunk`-key chunk of its LUT row's K blocks that starts before kv_len."""
    import torch
    nq = lut.shape[2]
    rows = (lq - torch.arange(nq, device=lut.device) * block_q).clamp(min=0, max=block_q)
    tiles = (rows + tile - 1) // tile
    keys = (kv_len - lut.long() * block_k).clamp(min=0, max=block_k)
    chunks = ((keys + chunk - 1) // chunk).sum(-1)
    return int((chunks * tiles).sum()) * chunk_bytes


def _bound(ops: dict, nbytes: int) -> float:
    return max(sum(n / PEAK[t] for t, n in ops.items()), nbytes / HBM) * 1e3


def _form(mod, name: str, *args):
    fn = getattr(mod, name, None)          # a tree without form functions: None
    return fn(*args) if fn else None


def _run(args, rec, kern, want, device_keys, walk_keys, extra=(), atol=4e-3):
    """Check kern() against want(), then time it; print the record."""
    import torch
    try:
        got = kern()
        kt.sync()
        rec.update(kt.within(got, want(), atol, 2e-2))
        del got
    except Exception as e:          # a kernel that fails is reported
        print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
        return
    if not args.check:
        ms = kt.times(kern, args.rounds, args.reps)
        dev = kt.device_ms(kern, args.reps, device_keys)
        rec.update({"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
                    "device_ms": dev,
                    "walk_device_ms": kt.device_ms(kern, args.reps, walk_keys),
                    "bound_share": rec["bound_ms"] / dev})
        for name, fn, keys in extra:
            rec[f"{name}_ms_median"] = statistics.median(kt.times(fn, args.rounds, args.reps))
            rec[f"{name}_device_ms"] = kt.device_ms(fn, args.reps, keys)
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _k19(args, base, randn, name: str) -> None:
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    bq, bk, topk = CASES[name]
    qp, kp_ = randn(1, HEADS, LP, DH), randn(1, HEADS, LP, DH)
    qi, qs = sf._quant_rows(qp.float())
    k = (kp_.float() + 0.5).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vs = sf._quant_rows(randn(1, HEADS, LP, DH).float())
    kvi, ks = sf.subquant_pack_kv_plain(k, mu, vi)
    _, lut, sel = get_block_map(qp[:, :, :L].transpose(1, 2), k[:, :, :L].transpose(1, 2),
                                topk, bq, bk)
    scale = DH ** -0.5
    # the live rows of the planes (a view: the launch is what is timed)
    kern = lambda: si8._sparse_i8_planes_cuda(qi, qs, kvi, ks, vs, lut, scale, bq, bk,  # noqa
                                              L)[:, :, :L]
    pairs = _pairs(lut, bq, bk)
    ops = {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs}
    nbytes = (qi.numel() + 4 * qs.numel() + kvi.numel() + 8 * ks.numel() + 2 * qi.numel()
              + 4 * lut.numel())
    rec = {**base, "kernel": "K19", "case": name,
           "shape": f"{HEADS} heads, {sel}/{LP // bk} blocks {bq}/{bk}",
           "form": _form(si8, "sparse_i8_planes_form", LP, LP, L, bq, bk),
           "bound_ms": _bound(ops, nbytes),
           # the wgmma form: 128-row tiles, 128-key chunks of packed rows and
           # their K and V scales
           "l2_gather_gb": _gather_bytes(lut, bq, bk, 128, 128, 128 * (2 * DH + 8)) / 1e9}
    _run(args, rec, kern,
         lambda: si8.sparse_attention_i8_planes_plain(qi, qs, kvi, ks, vs, lut, block_q=bq,
                                                      block_k=bk, kv_len=L)[:, :, :L],
         ("sparse_i8_planes_kernel", "sparse_i8_vt_kernel"),
         ("sparse_i8_planes_kernel", "sparse_i8_vt_kernel"))


def _k20(args, base, randn, name: str) -> None:
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    bq, bk, topk = CASES[name]
    q, k, v = randn(1, L, HEADS, DH), randn(1, L, HEADS, DH), randn(1, L, HEADS, DH)
    k = k - k.mean(dim=1, keepdim=True)
    _, lut, sel = get_block_map(q, k, topk, bq, bk)
    scale = DH ** -0.5
    kern = lambda: fa._sparse_flash_i8qk_cuda(q, k, v, lut, bq, bk, scale, L)  # noqa: E731
    k3 = lambda: fa._sparse_flash_cuda(q, k, v, lut, bq, bk, scale, L)       # noqa: E731
    pairs = _pairs(lut, bq, bk)
    ops = {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs}
    rec = {**base, "kernel": "K20", "case": name,
           "shape": f"{HEADS} heads, {sel}/{-(-L // bk)} blocks {bq}/{bk}",
           "form": _form(fa, "sparse_flash_i8qk_form", bq, bk, L, L, *fa._strides(q, k, v)),
           "bound_ms": _bound(ops, 2 * 4 * q.numel() + 4 * lut.numel()),
           # the wgmma form: 64-row tiles, 64-key chunks of int8 K, their
           # scales and bf16 V
           "l2_gather_gb": _gather_bytes(lut, bq, bk, 64, 64, 64 * (DH + 4 + 2 * DH)) / 1e9}
    _run(args, rec, kern,
         lambda: fa.sparse_flash_attention_i8qk_plain(q, k, v, lut, bq, bk, scale, L),
         ("flash_i8qk_kernel", "flash_fwd_kernel", "i8qk_quant"),
         ("flash_i8qk_kernel", "flash_fwd_kernel"),
         extra=[("k3", k3, ("sparse_flash_fwd_kernel", "flash_fwd_kernel"))])


def _k30(args, base, randn, name: str) -> None:
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    q, k, v = randn(1, L, HEADS, DH), randn(1, L, HEADS, DH), randn(1, L, HEADS, DH)
    k = k - k.mean(dim=1, keepdim=True)
    scale = DH ** -0.5
    pairs = L * L * HEADS
    rec = {**base, "kernel": "K30", "case": name,
           "shape": f"{HEADS} heads, dense {L}x{L}",
           "bound_ms": _bound({"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs},
                              2 * 4 * q.numel())}
    _run(args, rec, lambda: fa._flash_i8qk_cuda(q, k, v, scale, L),
         lambda: fa.flash_attention_i8qk_plain(q, k, v, scale, L),
         ("flash_i8qk_kernel", "flash_fwd_kernel", "i8qk_quant"),
         ("flash_i8qk_kernel", "flash_fwd_kernel"), atol=2e-2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--check", action="store_true", help="check, time nothing")
    args = p.parse_args(argv)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k19_k20")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    base = {"label": args.label, "card": card}
    for name in args.cases.split(","):
        {"k19": _k19, "k20": _k20, "k30": _k30}[name[:3]](args, base, randn, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
