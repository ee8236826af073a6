"""Card time of K3 (bf16 block-sparse flash attention) and K28 (block-scale
int8 SageSLA attention) at the main path's shapes.

Usage:
  python tools/time_k3_k28.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 7] [--reps 20] [--library]

Cases (480p/81f: 32,760 tokens, heads of 128):
  k3-1.3b, k3-14b    K3 as `sla` calls it: blocks 512/256, 12 of the 128 K
                     blocks a Q block (`get_block_map` at top-k 0.1 on the
                     random q and k), 12 or 40 heads;
  k3-1.3b-64, k3-14b-64  the same at 512/64 (`sla` at --sla_block 64: 51
                     of 512 K blocks);
  k28-1.3b           K28 as fused sagesla's block-scale branch calls it
                     (--sla_topk 0.3): blocks 512/256, 38 of 128 K blocks,
                     32,768 padded rows; int8 q (std ~3) with row scales,
                     K27's packed K|V rows and block scales and per-channel
                     V from their plain versions.
q, k, v (and K28's planes) are N(0, 1) bf16 from a seeded generator.

Each kernel is checked against its plain version (K3 atol 2e-2 + rtol 2e-2,
K28 atol 4e-3 + rtol 2e-2) and timed with CUDA events around `--reps`
launches, `--rounds` rounds, and under torch.profiler (`device_ms`: the
device time a call spends in the kernel, over `--reps` calls). One JSON line
a case: min / median / max ms, device ms, the form the launch took (where
the package names it), the bound (the query-key pairs these inputs need,
QK and P V at their types' dense peaks, or the bytes of the inputs and the
output at 3.35 TB/s, whichever is larger), the error, and the card's name
and power limit. Beside K28, on the same LUT and operands in its panel
layout, K7 (`_sparse_i8_vt_cuda`). With `--library`, beside K3,
`torch.nn.attention.flex_attention` compiled, with a `BlockMask` built from
the same LUT (`BlockMask.from_kv_blocks`, blocks of 512 x block_k) and a
mask of kv_len: the one PyTorch call that computes K3's function (the port
never calls it; "none" and the error where it does not compile). `--root
DIR` imports the package from the checkout at DIR, so two trees are timed
by one script, in turns, on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import kernel_timing as kt
from kernel_timing import HBM, PEAK

L, LP, DH, BQ = 32760, 32768, 128, 512
# name: (heads, block_k, top-k ratio)
CASES = {"k3-1.3b": (12, 256, 0.1), "k3-14b": (40, 256, 0.1),
         "k3-1.3b-64": (12, 64, 0.1), "k3-14b-64": (40, 64, 0.1),
         "k28-1.3b": (12, 256, 0.3)}


def _pairs(lut, block_k: int, lq: int = L, kv_len: int = L) -> int:
    """Query-key pairs of the valid rows and keys these LUT rows select."""
    import torch
    nq = lut.shape[2]
    q_rows = (lq - torch.arange(nq, device=lut.device) * BQ).clamp(max=BQ)
    k_rows = (kv_len - lut.long() * block_k).clamp(min=0, max=block_k)
    return int((k_rows.sum(-1) * q_rows).sum())


def _bound(ops: dict, nbytes: int) -> float:
    return max(sum(n / PEAK[t] for t, n in ops.items()), nbytes / HBM) * 1e3


def _form(mod, name: str, *args):
    fn = getattr(mod, name, None)          # a tree without form functions: None
    return fn(*args) if fn else None


def _flex(q, k, v, lut, block_k: int):
    """A compiled flex_attention call computing K3's function on (B, L, H,
    D) q, k, v and the LUT (B, H, nQ, sel): a BlockMask of 512 x block_k
    blocks whose kv blocks are each row's LUT ids, its mask_mod the same
    selection and kv_idx < L (so the mask is right whether or not a block
    is skipped)."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask, flex_attention
    B, Lq, H, D = q.shape
    nk = -(-k.shape[1] // block_k)
    sel = lut.shape[-1]
    idx = torch.zeros(*lut.shape[:3], nk, dtype=torch.int32, device=q.device)
    idx[..., :sel] = lut
    num = torch.full(lut.shape[:3], sel, dtype=torch.int32, device=q.device)
    chosen = torch.zeros(*lut.shape[:3], nk, dtype=torch.bool, device=q.device)
    chosen.scatter_(-1, lut.long(), True)
    kv_len = k.shape[1]

    def mask(b, h, q_idx, kv_idx):
        return chosen[b, h, q_idx // BQ, kv_idx // block_k] & (kv_idx < kv_len)

    bm = BlockMask.from_kv_blocks(num, idx, BLOCK_SIZE=(BQ, block_k), mask_mod=mask,
                                  seq_lengths=(Lq, k.shape[1]))
    fx = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: fx(qh, kh, vh, block_mask=bm)


def _k3(args, base, randn, name: str) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    heads, bk, topk = CASES[name]
    q, k, v = randn(1, L, heads, DH), randn(1, L, heads, DH), randn(1, L, heads, DH)
    _, lut, sel = get_block_map(q, k, topk, BQ, bk)
    scale = DH ** -0.5
    kern = lambda: fa._sparse_flash_cuda(q, k, v, lut, BQ, bk, scale, L)   # noqa: E731
    pairs = _pairs(lut, bk)
    ops = {"bf16": 4 * DH * pairs}
    rec = {**base, "kernel": "K3", "case": name,
           "shape": f"{heads} heads, {sel}/{-(-L // bk)} blocks {BQ}/{bk}",
           "form": _form(fa, "sparse_flash_form", BQ, bk, L, *fa._strides(q, k, v)),
           "bound_ms": _bound(ops, 2 * 4 * q.numel() + 4 * lut.numel())}
    try:
        got = kern()
        kt.sync()
        rec.update(kt.within(got, fa.sparse_flash_attention_plain(q, k, v, lut, BQ, bk,
                                                                  scale, L), 2e-2, 2e-2))
    except Exception as e:          # a kernel that fails is reported
        print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
        return
    del got
    ms = kt.times(kern, args.rounds, args.reps)
    dev = kt.device_ms(kern, args.reps, ("flash_fwd_kernel",))
    rec.update({"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
                "device_ms": dev, "tflops": ops["bf16"] / dev * 1e-9,
                "bound_share": rec["bound_ms"] / dev})
    if args.library:
        try:
            flex = _flex(q, k, v, lut, bk)
            out = flex()
            kt.sync(600.0)
            want = fa.sparse_flash_attention_plain(q, k, v, lut, BQ, bk, scale, L)
            rec["flex"] = kt.within(out.transpose(1, 2), want, 2e-2, 2e-2)
            fms = kt.times(flex, args.rounds, args.reps)
            rec["flex_ms_median"] = statistics.median(fms)
            rec["flex_device_ms"] = kt.device_ms(flex, args.reps)
        except Exception as e:      # no library time: say why
            rec["flex_ms_median"] = "none"
            rec["flex_error"] = f"{type(e).__name__}: {str(e)[:400]}"
    print(json.dumps(rec), flush=True)
    del q, k, v, lut
    torch.cuda.empty_cache()


def _k28(args, base, randn, name: str) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    heads, bk, topk = CASES[name]
    qp, kp_ = randn(1, heads, LP, DH), randn(1, heads, LP, DH)
    qi, qs = sf._quant_rows(3 * qp.float())
    k = (kp_.float() + 0.5).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(randn(1, heads, LP, DH), L)
    kvi, ksb = sf.subquant_pack_kv_plain(k, mu, vi, bk, L)
    kpan, vtp, _ = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L)
    _, lut, sel = get_block_map(qp[:, :, :L].transpose(1, 2), k[:, :, :L].transpose(1, 2),
                                topk, BQ, bk)
    scale = DH ** -0.5
    kern = lambda: si8._sparse_i8_planes_bs_cuda(qi, qs, kvi, ksb, vcs, lut, scale,  # noqa
                                                 BQ, bk, L)
    k7 = lambda: si8._sparse_i8_vt_cuda(qi, qs, kpan, vtp, ksb, vcs, lut, scale, BQ, bk,  # noqa
                                        L, None, None)
    pairs = _pairs(lut, bk)
    ops = {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs}
    nbytes = qi.numel() + 4 * qs.numel() + kvi.numel() + 2 * qi.numel() + 4 * lut.numel()
    rec = {**base, "kernel": "K28", "case": name,
           "shape": f"{heads} heads, {sel}/{LP // bk} blocks {BQ}/{bk}",
           "form": _form(si8, "sparse_i8_planes_bs_form", LP, LP, L, BQ, bk),
           "bound_ms": _bound(ops, nbytes)}
    try:
        got = kern()
        kt.sync()
        want = si8.sparse_attention_i8_planes_bs_plain(qi, qs, kvi, ksb, vcs, lut,
                                                       block_q=BQ, block_k=bk, kv_len=L)
        rec.update(kt.within(got[:, :, :L], want[:, :, :L], 4e-3, 2e-2))
        rec["k7"] = kt.within(k7()[:, :, :L], want[:, :, :L], 4e-3, 2e-2)
    except Exception as e:
        print(json.dumps({**rec, "error": str(e)[:300]}), flush=True)
        return
    del got, want
    ms = kt.times(kern, args.rounds, args.reps)
    dev = kt.device_ms(kern, args.reps, ("sparse_i8_planes_kernel", "sparse_i8_vt_kernel"))
    k7ms = kt.times(k7, args.rounds, args.reps)
    rec.update({"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
                "device_ms": dev, "tops": sum(ops.values()) / dev * 1e-9,
                "bound_share": rec["bound_ms"] / dev,
                "k7_ms_median": statistics.median(k7ms),
                "k7_device_ms": kt.device_ms(k7, args.reps, ("sparse_i8_vt_kernel",))})
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--library", action="store_true",
                   help="time flex_attention on K3's LUT beside K3")
    args = p.parse_args(argv)
    kt.use_root(args.root)

    import torch

    card = kt.card("time_k3_k28")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    base = {"label": args.label, "card": card}
    for name in args.cases.split(","):
        (_k28 if name.startswith("k28") else _k3)(args, base, randn, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
