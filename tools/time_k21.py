"""Card time and precision of K21 (the SLA linear branch: its kv pass, with
the reduce of the runs' partials, and its apply pass), and the device times
of the kernels that keep their first design (K8, K13, K15, K18, K27).

Usage:
  python tools/time_k21.py [--root DIR] [--label NAME] [--cases ...]
      [--rounds 7] [--reps 20]
  python tools/time_k21.py --probe
  python tools/time_k21.py --smoke [--root DIR]
  python tools/time_k21.py --design [--designs NAME,...] [--cases ...]

K21 cases, `<layout>-<heads>[-<V>]`: the 480p shape (32,760 live rows,
planes of 32,768) at 12 heads (1.3B) and 40 (14B), as the fused path gives
it (`planes`: (1, H, 32,768, 128) planes with a true length) and as the sla
path and training give it (`bhld`: (1, 32,760, H, 128) views); V of N(0,
1) by default, `-int8` V of uniform int8 values in bf16 (|kv| ~ 100, where
plain fp32 sums drift) and `-beyond` V with rows past fp16's range (2^17
(1 + |N(0, 1)|), one row in 16) and below its normal range (2^-20 N(0, 1),
one in 16). Each line holds, for the kv pass, the apply pass and the pair
(`la._linear_projected_cuda`, kvw = kv @ W^T in torch between them), the
time a call takes (CUDA events around `--reps` calls, `--rounds` rounds:
min, median, max), the device time of its kernels from torch.profiler (the
pair's without the kvw matmul: `pair_device_ms`), the byte bound (each
input read once, each output written once, at 3.35 TB/s) and the share of
it the device time reaches; kv and ksum against float64 sums (the largest
difference over rtol 1e-4 / atol 1e-4: `kv_tol_ratio_f64`); the output's
mean and largest |o - float64| and the fp32 plain version's; the card's
name and power limit. `--root DIR` imports the package from the checkout
at DIR (the parent unpacked beside this one), so two trees are timed by
one script, in turns, on one card.

Other cases: `k8-512` and `k8-32760` (K8 over 512 x 5120 and 32,760 x 5120
bf16 rows), `k13` (12 x 32,768 x 128 planes -> 32,760 x 1536 int8), `k15`
(32,760 x 5120 rows' RMS), `k18` and `k27` (12 heads of 32,768 K rows and
int8 V, 256-row blocks for K27): the same event and device times with the
byte bound.

`--probe` runs this tree's kv pass on inputs whose one 64-row chunk holds
phi = 2^-7 exactly and V rows of 2^24 and of small powers of two: the
fp32 values the tensor core's sum gives (`tc_probe`) against the exact sum
rounded to nearest, which show whether its sum drops the bits of terms
below 2^-24 of the largest.

`--smoke` prints, for the draws of chip_smoke's K21 float64 checks
(`chip_smoke.k21_f64_inputs`), the output's mean |o - float64| of the
package imported (`--root`): the figure chip_smoke's
`K21_PARENT_MEAN_ERR` records of the parent, which its check holds the
kernel to 1.1x of.

`--design` times this tree's design variants (`DESIGNS`): for each, a copy
of the package under `turbodiffusion_tpu_torch/_build/design/<name>` with
its kernel source patched, timed in a process of its own.
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

DH, L480, LP480 = 128, 32760, 32768
CASES = ("planes-12", "planes-40", "bhld-12", "bhld-40", "planes-40-int8", "planes-12-beyond")

# the design variants: (name, [(file under csrc/, its text, the
# replacement), ...]): the kv pass's fragment sums without the Kahan
# compensation (plain fp32 sums, as K6's); the products of a 64-row chunk or
# of a 32-row pair of k steps into one fragment (this tree: a 16-row k
# step); its phi warpgroups a row at a time (this tree: two); ablations
# (wrong outputs by design; their times say what a piece costs): the kv pass
# without its products or without building phi, the apply pass without its
# products
_WGMMA = ("        wgmma_bf16_ss_mn(frag, sw128_desc_mn(a0 + 2 * p * kPhiTile + ks * 2048, 0), "
          "db, 1);\n")
_FENCE = "      wgmma_fence();\n#pragma unroll\n      for (int p = kParts - 1; p >= 0; --p)"
DESIGNS = [
    ("plain-sums", [("linear_attention.cu",
                     "        frag[e] = __fsub_rn(frag[e], __fsub_rn(t, acc[e]));",
                     "        frag[e] = 0.f;")]),
    ("chunk-fragments", [("linear_attention.cu", _FENCE, "      if (ks == 0)" + _FENCE[5:]),
                         ("linear_attention.cu", _WGMMA + "      wgmma_commit();\n",
                          _WGMMA + "      if (ks + 1 < kRows / 16) continue;\n"
                          "      wgmma_commit();\n")]),
    ("frag32", [("linear_attention.cu", _FENCE, "      if (ks % 2 == 0)" + _FENCE[5:]),
                ("linear_attention.cu", _WGMMA + "      wgmma_commit();\n",
                 _WGMMA + "      if (ks % 2 == 0) continue;\n      wgmma_commit();\n")]),
    ("kv-mma-ablate", [("linear_attention.cu", _WGMMA, "        ;\n")]),
    ("kv-build-ablate", [("linear_attention.cu",
                          "        build_rows<kPhiRows>(kst, buf, live, rr + 16 * q, l16, ksl);",
                          "        ;")]),
    ("kv-phi-rows1", [("linear_attention.cu", "constexpr int kPhiRows = 2;",
                         "constexpr int kPhiRows = 1;")]),
    ("ap-mma-ablate", [("linear_attention.cu", "        wgmma_bf16_rs<1>(acc, ah + 4 * ks, dh);\n"
                        "        wgmma_bf16_rs<1>(acc, ah + 4 * ks, dl);\n"
                        "        wgmma_bf16_rs<1>(acc, al + 4 * ks, dh);\n", "")]),
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
                raise SystemExit(f"time_k21: {name}: text not found once: {old!r}")
            path.write_text(text.replace(old, new))
        cmd = [sys.executable, __file__, "--root", str(dst), "--label", name,
               "--cases", args.cases, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        cmd += ["--smoke"] if args.smoke else []
        rc |= subprocess.run(cmd).returncode
    return rc


def _ptxas() -> dict:
    """ptxas's registers, stack frame and spill stores of K21's kernels,
    when this process built the library (else empty)."""
    import re
    from turbodiffusion_tpu_torch.ops import _build
    out, name = {}, None
    for ln in _build.load().build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(k21\w*|linear_\w+?kernel)\w*'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"{m.group(1)} B stack, {m.group(2)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
            name = None
    return out


def _timed(args, fn, nbytes: float, ops: float = 0.0, keys=("",)) -> dict:
    """Event and device times of fn, its bound and share."""
    ms = kt.times(fn, args.rounds, args.reps)
    dev = kt.device_ms(fn, args.reps, keys)
    bound = max(nbytes / HBM, ops / PEAK["bf16"]) * 1e3
    return {"ms_min": min(ms), "ms_median": statistics.median(ms), "ms_max": max(ms),
            "device_ms": dev, "bound_ms": bound, "device_share_of_bound": bound / dev}


def _v(shape, kind: str, g, row_dim: int):
    """bf16 V: N(0, 1); "int8": uniform int8 values; "beyond": N(0, 1) with
    rows 3, 19, ... at 2^17 (1 + |N(0, 1)|) and rows 7, 23, ... times 2^-20."""
    import torch
    if kind == "int8":
        return torch.randint(-127, 128, shape, generator=g, device="cuda").float().bfloat16()
    v = torch.randn(shape, generator=g, device="cuda")
    if kind == "beyond":
        big = v.narrow(row_dim, 3, shape[row_dim] - 3)
        big = big.unfold(row_dim, 1, 16)
        big.copy_(2.0 ** 17 * (1 + big.abs()))
        tiny = v.narrow(row_dim, 7, shape[row_dim] - 7).unfold(row_dim, 1, 16)
        tiny.mul_(2.0 ** -20)
    return v.bfloat16()


def _k21(args, card: str, la, layout: str, H: int, vkind: str) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import _build
    g = torch.Generator(device="cuda").manual_seed(21 * H + len(vkind))
    L = L480
    w = torch.randn((DH, DH), generator=g, device="cuda") * DH ** -0.5
    bias = torch.randn((DH,), generator=g, device="cuda") * 0.01
    if layout == "planes":
        q, k = (torch.randn((1, H, LP480, DH), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        v = _v((1, H, LP480, DH), vkind, g, 2)
        k[:, :, L:], v[:, :, L:] = float("nan"), float("nan")     # garbage past the length
        qv, kv_, vv, Lq = q, k, v, LP480

        def pair():
            return la.linear_projected_planes(q, k, v, w, bias, L)

        def plain():
            return la.linear_projected_planes_plain(q, k, v, w, bias, L)
    else:
        q, k = (torch.randn((1, L, H, DH), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        v = _v((1, L, H, DH), vkind, g, 1)
        qv, kv_, vv, Lq = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), L

        def pair():
            return la.linear_attention_projected(q, k, v, w, bias)

        def plain():
            return la.linear_attention_projected_plain(q, k, v, w, bias)

    def kv_pass():
        return la._linear_kv_sums(kv_, vv, L)

    kv, ksum = kv_pass()
    kvw = torch.matmul(kv, w.t()).contiguous()
    out = torch.empty(qv.shape, dtype=torch.bfloat16, device="cuda")

    def apply_pass():
        st = [qv.stride(0), qv.stride(1), qv.stride(2)]
        so = [out.stride(0), out.stride(1), out.stride(2)]
        rc = _build.load().tdx_linear_apply(
            qv.data_ptr(), kvw.data_ptr(), ksum.data_ptr(), bias.data_ptr(), out.data_ptr(),
            1, H, Lq, *st, *so, _build.stream_ptr(qv))
        _build.check(rc, "tdx_linear_apply")
        return out

    rec = {"label": args.label, "kernel": "K21", "layout": layout, "heads": H, "rows": L,
           "v": vkind, "card": card}
    if hasattr(la, "linear_form"):
        rec["form"] = la.linear_form(
            1, H, Lq, L, [t.data_ptr() for t in (qv, kv_, vv, out)],
            [t.stride(i) for t in (qv, kv_, vv, out) for i in range(3)])
    # float64 references over the live rows
    valid = (torch.arange(kv_.shape[2], device="cuda") < L)[:, None]
    pk = torch.where(valid, torch.softmax(kv_.double(), -1), 0.0)
    ref_kv = torch.matmul(pk.transpose(-1, -2), torch.where(valid, vv.double(), 0.0))
    ref_ks = pk.sum(2, keepdim=True)
    del pk
    for got, ref, key in ((kv, ref_kv, "kv"), (ksum, ref_ks, "ksum")):
        err = (got.double() - ref).abs()
        rec[f"{key}_max_abs_err_f64"] = float(err.max())
        rec[f"{key}_tol_ratio_f64"] = float((err / (1e-4 + 1e-4 * ref.abs())).max())
    again = kv_pass()
    rec["kv_rerun_bit_equal"] = bool(torch.equal(again[0], kv) and torch.equal(again[1], ksum))
    pq = torch.softmax(qv[:, :, :L].double(), -1)
    o64 = (torch.matmul(pq, torch.matmul(ref_kv, w.double().t()))
           / (1e-5 + (pq * ref_ks).sum(-1, keepdim=True)) + bias.double())
    del pq
    o = pair()
    o = (o if layout == "planes" else o.transpose(1, 2))[:, :, :L]
    p = plain()
    p = (p if layout == "planes" else p.transpose(1, 2))[:, :, :L]
    rec["out_mean_abs_err_f64"] = float((o.double() - o64).abs().mean())
    rec["out_max_abs_err_f64"] = float((o.double() - o64).abs().max())
    rec["plain_mean_abs_err_f64"] = float((p.double() - o64).abs().mean())
    rec["out_vs_plain_max_abs"] = float((o.float() - p.float()).abs().max())
    rec["out_rerun_bit_equal"] = bool(torch.equal(pair(), pair()))
    del o, p, o64, ref_kv, ref_ks
    torch.cuda.synchronize()
    n = H * L * DH * 2                               # one bf16 tensor's live bytes
    small = 4 * H * DH * (DH + 1)                    # kv and ksum (kvw and ksum for the apply)
    ops = 3 * 2 * H * L * DH * DH                    # three bf16 products
    rec["kv_pass"] = _timed(args, kv_pass, 2 * n + small, ops)
    rec["apply_pass"] = _timed(args, apply_pass, 2 * n + small, ops)
    rec["pair"] = _timed(args, pair, 4 * n + 2 * small, 2 * ops)
    rec["pair_device_ms"] = kt.device_ms(pair, args.reps, ("kv", "apply"))
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def _probe(la) -> None:
    """The tensor core's sum on one 64-row chunk: k rows of zeros (phi =
    2^-7 exactly, split as h1 = 2^-7, h2 = h3 = 0), V row 0 = 2^24 in every
    column, rows 1-15 = 2^-j in column j (j < 12, products 2^-(7 + j)),
    the rest 0; kv[0, j] - 2^17 against the exact sum rounded to nearest."""
    import torch
    k = torch.zeros((1, 1, 64, DH), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros((1, 1, 64, DH), device="cuda")
    v[0, 0, 0] = 2.0 ** 24
    for j in range(12):
        v[0, 0, 1:16, j] = 2.0 ** -j
    kv, _ = la._linear_kv_sums(k, v.bfloat16(), 64)
    torch.cuda.synchronize()
    got = [float(kv[0, 0, 0, j].double() - 2.0 ** 17) for j in range(12)]
    exact = [float(torch.tensor(2.0 ** 17 + 15 * 2.0 ** -(7 + j), dtype=torch.float64)
                   .float().double() - 2.0 ** 17) for j in range(12)]
    print(json.dumps({"tc_probe": got, "exact_rn": exact,
                      "terms": [2.0 ** -(7 + j) for j in range(12)],
                      "ulp_of_sum": 2.0 ** -6}), flush=True)


def _smoke(args, card: str, la) -> None:
    """chip_smoke's K21 float64 draws through the imported package."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)      # this tree's, whatever --root
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    for case in chip_smoke.K21_PARENT_MEAN_ERR:
        args_ = chip_smoke.k21_f64_inputs(case)
        kv64, ks64, o64 = chip_smoke.k21_f64(*args_)
        q, k, v, *_, layout = args_
        kv_, vv = (k, v) if layout == "planes" else (k.transpose(1, 2), v.transpose(1, 2))
        kv, _ = la._linear_kv_sums(kv_, vv, chip_smoke.L)
        o = chip_smoke.k21_output(la, *args_).double()
        print(json.dumps({"label": args.label, "smoke_case": case, "card": card,
                          "kv_tol_ratio_f64": float(((kv.double() - kv64).abs()
                                                     / (1e-4 + 1e-4 * kv64.abs())).max()),
                          "out_mean_abs_err_f64": float((o - o64).abs().mean()),
                          "out_max_abs_err_f64": float((o - o64).abs().max())}), flush=True)
        del o, o64
        torch.cuda.empty_cache()


def _others(args, card: str, case: str) -> None:
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    g = torch.Generator(device="cuda").manual_seed(8)
    rec = {"label": args.label, "kernel": case, "card": card}
    if case.startswith("k8-"):
        M = int(case[3:])
        x = torch.randn((M, 5120), generator=g, device="cuda").bfloat16()
        rec.update(_timed(args, lambda: qt._quantize_rows_cuda(x), M * 5120 * 3 + 4 * M))
    elif case == "k13":
        planes = torch.randn((1, 12, LP480, DH), generator=g, device="cuda").bfloat16()
        rec.update(_timed(args, lambda: sf._unfold_quant_cuda(planes, L480),
                          L480 * 1536 * 3 + 4 * L480))
    elif case == "k15":
        x = torch.randn((1, L480, 5120), generator=g, device="cuda").bfloat16()
        rec.update(_timed(args, lambda: sf._row_rms_inv_cuda(x, 1e-6, None, 0),
                          L480 * 5120 * 2 + 4 * L480))
    else:
        k = torch.randn((1, 12, LP480, DH), generator=g, device="cuda").bfloat16()
        k[:, :, L480:] = 0
        mu = k[:, :, :L480].float().mean(2, keepdim=True)
        vi = torch.randint(-127, 128, (1, 12, LP480, DH), generator=g, device="cuda",
                           dtype=torch.int8)
        n = 12 * LP480 * DH
        if case == "k18":
            rec.update(_timed(args, lambda: sf._subquant_pack_kv_cuda(k, mu, vi),
                              2 * n + n + 2 * n + 4 * 12 * LP480))
        else:
            rec.update(_timed(args, lambda: sf._subquant_pack_kv_blocks_cuda(k, mu, vi, 256,
                                                                             L480),
                              2 * n + n + 2 * n + 4 * 12 * (LP480 // 256)))
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
    p.add_argument("--probe", action="store_true",
                   help="the tensor core's sum on crafted inputs (this tree)")
    p.add_argument("--smoke", action="store_true",
                   help="chip_smoke's K21 float64 draws: the output's mean error")
    p.add_argument("--design", action="store_true",
                   help="time this tree's design variants")
    p.add_argument("--designs", default="",
                   help="with --design: the variants to time (default: all)")
    args = p.parse_args(argv)
    if args.design:
        return _design(args)
    kt.use_root(args.root)

    from turbodiffusion_tpu_torch.ops import linear_attention as la

    card = kt.card("time_k21")
    print(json.dumps({"label": args.label, "card": card, "ptxas": _ptxas()}), flush=True)
    if args.probe:
        _probe(la)
        return 0
    if args.smoke:
        _smoke(args, card, la)
        return 0
    for case in args.cases.split(","):
        parts = case.split("-")
        if parts[0] in ("planes", "bhld"):
            _k21(args, card, la, parts[0], int(parts[1]), parts[2] if len(parts) > 2 else "normal")
        elif case in ("k8-512", "k8-32760", "k13", "k15", "k18", "k27"):
            _others(args, card, case)
        else:
            raise SystemExit(f"time_k21: unknown case {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
