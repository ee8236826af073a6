"""K24 (the block-sparse attention's dk / dv pass) against its plain version
over many seeds, and where its error comes from.

Usage:
  python tools/k24_seeds.py [--root DIR] [--label NAME] [--seeds 10] [--first 2400]

Inputs as chip_smoke's K23 / K24 checks draw them, from a generator seeded
with each seed in turn (seeds 2400.. are those of chip_smoke's loop
`_k24_seeds`): the 1.3B training shape (32,760 tokens, 12 heads of
128, blocks 512/256, topk 0.1), q of std 3, k, v and dO of std 1, views of
buffers whose rows past L hold NaN, one K-block that no Q-block selects;
(lse, delta) from K23. For each seed, one JSON line: the worst error of dk
and of dv as a share of the check's tolerance (atol 0.02 + rtol 0.02 |want|,
want = the plain version), and, on the K-block that holds dk's worst
element, the same share of the kernel and of the plain version against a
float64 reference of the same function (s, P = exp(s - lse), dp, dS = P
(dp - delta) scale in float64, P and dS rounded to bf16 where the function
rounds them, the sums in float64). Then the candidates for the error, each
measured on that block:
  * `delta`: the reference with delta recomputed in float64 as rowsum(P dp)
    over the row's selected keys, against K23's fp32 acc3 / l (both the
    kernel and the plain version read K23's);
  * `ds_flips`: the share of dS elements whose bf16 rounding differs between
    the plain version's fp32 chain and the float64 one (dp - delta cancels
    before the rounding), and what those flips alone move dk by;
  * `dk_sum`: the float64 reference's rounded dS summed into dk in fp32
    (torch.matmul) against the float64 sum: the error of an fp32 sum over
    the block's inverse-LUT Q-blocks;
  * S's own sum in the kernel (the wgmma chain over 128 channels):
    `--design` runs K23 and K24 with S (K24: S^T) chained over 128
    channels or in 2, 4 or 8 parts, each chained on the tensor core and
    added to the sum in fp32 (`DESIGNS`), beside this tree's split (K23
    chained, K24 in two halves).
Then, over every K-block of every head (`all_blocks`), dk and dv of the
kernel and of the plain version against the float64 reference: the largest
share of the tolerance and the mean |error|; and, on the worst element's
head (`k23_ld_vs_f64`), K23's (lse, delta) from the kernel and from its
plain version against float64 ones (softmax over each row's selected keys):
the largest |error| of each.
`--root DIR` imports the package from the checkout at DIR. `--design` runs
this script on copies of the package under
`turbodiffusion_tpu_torch/_build/design/<name>` with K24 patched
(`DESIGNS`), each in a process of its own; their lines carry the name.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import kernel_timing as kt
from kernel_timing import ROOT

L, LP, HEADS, DH, BQ, BK, TOPK, ZERO_BLOCK = 32760, 32768, 12, 128, 512, 256, 0.1, 5
ATOL = RTOL = 0.02


# K23 / K24's variants of the kernel's split (K23's S chained over 128
# channels, K24's S^T in two chained halves added in fp32): both chained
# (the running sum carried, and truncated, by every k16 step), K24's in 4
# or 8 parts, K23's in 2, both in 8
_K24 = "csrc/sparse_attention_bwd.cu"
_SPLIT = "constexpr int kSplitS23 = 1, kSplitS24 = 2;"
DESIGNS = [(name, _K24, [(_SPLIT, f"constexpr int kSplitS23 = {a}, kSplitS24 = {b};")])
           for name, a, b in (("chained", 1, 1), ("split24-s4", 1, 4), ("split24-s8", 1, 8),
                              ("split23-s2", 2, 2), ("split-s8", 8, 8))]


def _share(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / (ATOL + RTOL * want.double().abs())).max())


def _inputs(seed: int, device="cuda"):
    import numpy as np
    import torch
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    g = torch.Generator(device=device).manual_seed(seed)

    def view(std):
        t = (torch.randn((1, LP, HEADS, DH), generator=g, device=device) * std).bfloat16()
        t[:, L:] = float("nan")
        return t[:, :L]

    q, k, v = view(3.0), view(1.0), view(1.0)
    lut = get_block_map(q, k, TOPK, BQ, BK)[1]
    a = lut.cpu().numpy().copy()
    nK = -(-L // BK)
    for row in a.reshape(-1, a.shape[-1]):
        if ZERO_BLOCK in row:
            row[row == ZERO_BLOCK] = next(c for c in range(nK)
                                          if c != ZERO_BLOCK and c not in row)
    lut = torch.from_numpy(np.ascontiguousarray(a)).to(lut.device)
    return q, k, v, view(1.0), lut


def _block_terms(q, k, v, do, ld, inv, bh: int, kb: int):
    """The float64 pieces of K-block kb of (batch 0, head bh): rows of k, v
    (256, 128), the gathered q, dO (rows, 128) of its Q-blocks, their lse and
    K23's delta, every in float64."""
    import torch
    h = bh
    row = inv[bh, kb]
    ids = row[1:1 + int(row[0])].long().tolist()
    rows = torch.cat([torch.arange(i * BQ, min((i + 1) * BQ, L)) for i in ids]).to(k.device)
    ks = k[0, kb * BK:(kb + 1) * BK, h].double()
    vs = v[0, kb * BK:(kb + 1) * BK, h].double()
    qg, dog = q[0, rows, h].double(), do[0, rows, h].double()
    lse, dl = ld[bh, rows, 0].double(), ld[bh, rows, 1].double()
    return ks, vs, qg, dog, lse, dl, rows


def _ref(ks, vs, qg, dog, lse, dl, scale, round_ds=True):
    """dk, dv of one K-block in float64; P (for dv) and dS (for dk) rounded
    to bf16 where the function rounds them (round_ds), and dS itself."""
    import torch
    st = ks @ qg.T * scale
    p = torch.exp(st - lse[None])
    dpt = vs @ dog.T
    ds = p * (dpt - dl[None]) * scale
    pr = p.to(torch.bfloat16).double()
    dsr = ds.to(torch.bfloat16).double() if round_ds else ds
    return dsr @ qg, pr @ dog, ds, p, dpt


def _exact_delta(q, k, v, do, lut, bh: int, rows, scale):
    """rowsum(P dp) over each row's selected keys, in float64 (the delta
    K23 computes as acc3 / l in fp32)."""
    import torch
    out = torch.empty(len(rows), dtype=torch.float64, device=k.device)
    qb = rows // BQ
    for i in qb.unique().tolist():
        sel = (qb == i).nonzero().squeeze(1)
        keys = torch.cat([torch.arange(j * BK, min((j + 1) * BK, L))
                          for j in lut[0, bh, i].long().tolist()]).to(k.device)
        qr, dr = q[0, rows[sel], bh].double(), do[0, rows[sel], bh].double()
        s = qr @ k[0, keys, bh].double().T * scale
        p = torch.softmax(s, -1)
        out[sel] = (p * (dr @ v[0, keys, bh].double().T)).sum(-1)
    return out


def _all_blocks(q, k, v, do, ld, inv, got, plain, scale) -> dict:
    """dk and dv of every K-block of every head against the float64
    reference: the largest share of the tolerance and the mean |error|,
    of the kernel (got) and of the plain version (plain)."""
    import torch
    out = {n: {"dk_share": 0.0, "dv_share": 0.0, "dk_mean_abs": 0.0, "dv_mean_abs": 0.0}
           for n in ("kernel", "plain")}
    n_el = 0
    for h in range(HEADS):
        for kb in range(inv.shape[1]):
            if int(inv[h, kb, 0]) == 0:
                continue
            ks, vs, qg, dog, lse, dl, _ = _block_terms(q, k, v, do, ld, inv, h, kb)
            dk64, dv64 = _ref(ks, vs, qg, dog, lse, dl, scale)[:2]
            blk = slice(kb * BK, (kb + 1) * BK)
            n_el += dk64.numel()
            for name, (dk, dv) in (("kernel", got), ("plain", plain)):
                r = out[name]
                for key, a, w in (("dk", dk[0, blk, h], dk64), ("dv", dv[0, blk, h], dv64)):
                    r[key + "_share"] = max(r[key + "_share"], _share(a, w))
                    r[key + "_mean_abs"] += float((a.double() - w).abs().sum())
    for r in out.values():
        r["dk_mean_abs"] /= n_el
        r["dv_mean_abs"] /= n_el
    return out


def _exact_ld(q, k, v, do, lut, h: int, scale):
    """(lse, delta) of every row of head h in float64: the softmax over each
    row's selected keys."""
    import torch
    lse = torch.empty(L, dtype=torch.float64, device=q.device)
    dl = torch.empty_like(lse)
    for i in range(lut.shape[2]):
        rows = slice(i * BQ, min((i + 1) * BQ, L))
        keys = torch.cat([torch.arange(j * BK, min((j + 1) * BK, L))
                          for j in lut[0, h, i].long().tolist()]).to(k.device)
        s = q[0, rows, h].double() @ k[0, keys, h].double().T * scale
        lse[rows] = torch.logsumexp(s, -1)
        p = torch.softmax(s, -1)
        dl[rows] = (p * (do[0, rows, h].double() @ v[0, keys, h].double().T)).sum(-1)
    return lse, dl


def _design(args) -> int:
    rc = 0
    for name, src, edits in DESIGNS:
        dst = ROOT / "turbodiffusion_tpu_torch" / "_build" / "design" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "turbodiffusion_tpu_torch", dst / "turbodiffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "turbodiffusion_tpu_torch" / src
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"k24_seeds: {name}: text not found once in {src}: {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
        rc |= subprocess.run([sys.executable, __file__, "--root", str(dst), "--label", name,
                              "--seeds", str(args.seeds), "--first", str(args.first)]).returncode
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--first", type=int, default=2400)
    ap.add_argument("--design", action="store_true", help="run K24's variants (DESIGNS)")
    args = ap.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    import torch
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb

    card = kt.card("k24_seeds")
    scale = DH ** -0.5
    nK = -(-L // BK)
    for seed in range(args.first, args.first + args.seeds):
        q, k, v, do, lut = _inputs(seed)
        _, ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, BQ, BK, scale, L)
        inv = sb.inverse_lut(lut, nK)
        dk, dv = sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, BQ, BK, scale, L)
        dk_p, dv_p = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, BQ, BK, scale, L)
        kt.sync()
        rec = {"label": args.label, "card": card, "seed": seed,
               "dk_share": _share(dk, dk_p), "dv_share": _share(dv, dv_p)}
        # dk's worst element: its K-block
        err = ((dk.double() - dk_p.double()).abs()
               / (ATOL + RTOL * dk_p.double().abs()))[0]
        r, h, c = (int(i) for i in torch.unravel_index(err.argmax(), err.shape))
        kb = r // BK
        ks, vs, qg, dog, lse, dl, rows = _block_terms(q, k, v, do, ld, inv, h, kb)
        dk64, dv64, ds64, p64, dpt64 = _ref(ks, vs, qg, dog, lse, dl, scale)
        blk = slice(kb * BK, (kb + 1) * BK)
        rec.update({"worst": {"row": r, "head": h, "channel": c, "k_block": kb,
                              "q_blocks": int(inv[h, kb, 0]),
                              "kernel": float(dk[0, r, h, c]),
                              "plain": float(dk_p[0, r, h, c]),
                              "ref64": float(dk64[r - kb * BK, c])},
                    "block_dk_share_kernel_vs_ref64": _share(dk[0, blk, h], dk64),
                    "block_dk_share_plain_vs_ref64": _share(dk_p[0, blk, h], dk64),
                    "block_dv_share_kernel_vs_ref64": _share(dv[0, blk, h], dv64),
                    "block_dv_share_plain_vs_ref64": _share(dv_p[0, blk, h], dv64)})
        # candidate: delta from K23's fp32 acc3 / l
        dl_x = _exact_delta(q, k, v, do, lut, h, rows, scale)
        dk_x = _ref(ks, vs, qg, dog, lse, dl_x, scale)[0]
        rec["delta"] = {"max_abs_diff_k23_vs_f64": float((dl - dl_x).abs().max()),
                        "dk_share_moved": _share(dk_x, dk64)}
        # candidate: dS's bf16 rounding after dp - delta (the plain's fp32 chain)
        st32 = (ks.float() @ qg.float().T) * scale
        p32 = torch.exp(st32 - lse.float()[None])
        ds32 = p32 * ((vs.float() @ dog.float().T) - dl.float()[None]) * scale
        flips = ds32.bfloat16() != ds64.bfloat16()
        dk_f = ds32.bfloat16().double() @ qg
        rec["ds_flips"] = {"share_of_elements": float(flips.double().mean()),
                           "dk_share_moved": _share(dk_f, dk64),
                           "worst_element_moved": float(dk_f[r - kb * BK, c]
                                                        - dk64[r - kb * BK, c])}
        # candidate: dk's fp32 sum over the block's Q-blocks
        dk_s = (ds64.bfloat16().float() @ qg.float()).double()
        rec["dk_sum"] = {"dk_share_moved": _share(dk_s, dk64)}
        rec["all_blocks"] = _all_blocks(q, k, v, do, ld, inv, (dk, dv), (dk_p, dv_p), scale)
        lse64, dl64 = _exact_ld(q, k, v, do, lut, h, scale)
        ld_p = sb.sparse_bwd_dq_plain(q, k, v, do, lut, BQ, BK, scale, L)[1]
        rec["k23_ld_vs_f64"] = {
            name: {"lse": float((x[h, :L, 0].double() - lse64).abs().max()),
                   "delta": float((x[h, :L, 1].double() - dl64).abs().max())}
            for name, x in (("kernel", ld), ("plain", ld_p))}
        print(json.dumps(rec), flush=True)
        del q, k, v, do, ld, dk, dv, dk_p, dv_p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
