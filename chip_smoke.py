"""Smoke run of the PyTorch port (`turbodiffusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --phases 1,2

Phases, each printing one line of its numbers:
  1. device and build: the card's name and power limit (nvidia-smi), and the
     time to build the CUDA kernels from `turbodiffusion_tpu_torch/csrc/`;
  2. every kernel of the two paths against its plain PyTorch version on the
     card, at the main path's shapes (Wan2.1-1.3B, 480p/81f: 32,760 tokens,
     12 heads x 128, dim 1536, 512 text tokens; sagesla blocks 512/256, 12 of
     128 K blocks): max absolute error under the stated tolerance (int8
     outputs within 1 LSB), and both times (CUDA events, median of a few
     runs);
  3. one full-width 1.3B `WanAttentionBlock` with seeded random non-zero
     weights at one 480p latent frame (1,560 tokens), `sla` and `sagesla`
     (the latter with a non-zero `proj_l`, so the fused linear epilogue
     runs): the kernels on the card against the plain versions on the CPU,
     on the Q blocks whose block-map rows agree as sets;
  4. the slice: `WanPipeline.create(..., attention_type="sagesla")` with
     random weights and two 480p/81f 4-step `generate_t2v` requests, then one
     `attention_type="sla"` request; per request the text-encode, denoise and
     VAE-decode times, peak device memory, and the launch count of every
     kernel, set to 0 just before the request and read just after (sagesla:
     K1 3, K2 1, K4 1, K5 3, K6 1, K7 1 per block; sla: K1 3, K2 3, K3 1, K4
     1; x 30 blocks x 4 steps), which shows each path went through its
     kernels; then each path's denoise under torch.profiler: device time by
     kernel category and the device's idle share.
Then one JSON line with every kernel's numbers, the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero; without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

# main-path geometry: Wan2.1-1.3B at 480p/81f
B, L, DIM, HEADS, DH, TEXT = 1, 32760, 1536, 12, 128, 512
ATOL, RTOL = 2e-2, 2e-2           # bf16 kernel vs plain version on the card
BLOCK_ATOL, BLOCK_RTOL = 0.1, 0.05  # bf16 block, card vs CPU (other GEMMs)
BQ, BK, TOPK = 512, 256, 0.1        # sagesla / sla blocks and top-k ratio
LP = -(-L // 512) * 512             # the fused path's padded length
# launches per request: 30 blocks x 4 steps x per-block calls
EXPECTED_LAUNCHES = {
    "sagesla": {"K1": 360, "K2": 120, "K3": 0, "K4": 120, "K5": 360,
                "K6": 120, "K7": 120},
    "sla": {"K1": 360, "K2": 360, "K3": 120, "K4": 120, "K5": 0, "K6": 0,
            "K7": 0},
}
REPS = 5          # timed runs of each kernel (plain versions: REPS // 2)
REQUESTS = {"sagesla": 2, "sla": 1}   # phase-4 requests per path

KERNELS = {
    # name: (source, TPU kernel launch it replaces)
    "K1": ("turbodiffusion_tpu_torch/csrc/fused_norm.cu",
           "turbodiffusion_tpu/ops/fused_norm.py:155"),
    "K2": ("turbodiffusion_tpu_torch/csrc/fused_norm.cu",
           "turbodiffusion_tpu/ops/fused_norm.py:317"),
    "K3": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
           "turbodiffusion_tpu/ops/flash_pallas.py:1254"),
    "K4": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
           "turbodiffusion_tpu/ops/flash_pallas.py:1121"),
    "K5": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
           "turbodiffusion_tpu/ops/sla_fused.py:228"),
    "K6": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
           "turbodiffusion_tpu/ops/sla_fused.py:455"),
    "K7": ("turbodiffusion_tpu_torch/csrc/sparse_i8_attention.cu",
           "turbodiffusion_tpu/ops/flash_pallas.py:1032"),
}


def _launchers():
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    return {"K1": fn._mln_cuda, "K2": fn._rmsrope_cuda,
            "K3": fa._sparse_flash_cuda, "K4": fa._flash_cuda,
            "K5": sf._head_planes_cuda, "K6": sf._subquant_pack_kvt_cuda,
            "K7": si8._sparse_i8_vt_cuda}


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()                                          # warm up
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _compare(name, got, want, atol, rtol):
    """(max abs error, mean abs error, int8 LSB difference); raises past
    atol + rtol * |want|, or past 1 LSB for int8 outputs. Tuples and dicts
    compare element by element and give the worst of each."""
    import torch
    if isinstance(got, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: outputs {sorted(got)} != {sorted(want)}")
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]
    if isinstance(got, (tuple, list)):
        errs = [_compare(name, a, b, atol, rtol) for a, b in zip(got, want)]
        return tuple(max(e[i] for e in errs) for i in range(3))
    if got.dtype == torch.int8:
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        d = int((got.int() - want.int()).abs().max())
        if d > 1:
            raise AssertionError(f"{name}: int8 output off by {d} LSB")
        return 0.0, 0.0, d
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    worst = float((err - bound).max())
    max_err, mean_err = float(err.max()), float(err.mean())
    if worst > 0:
        raise AssertionError(f"{name}: max |err| {max_err:.4g} exceeds "
                             f"atol {atol} + rtol {rtol}*|want|")
    return max_err, mean_err, 0


def phase1():
    from turbodiffusion_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = _build.load()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase1 device: {smi} | kernel build {lib.build_seconds:.1f} s "
          f"(load {wall:.1f} s) | ptxas: {' / '.join(ptxas)}", flush=True)
    return smi


def phase2(reps: int = REPS):
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    x = randn(B, L, DIM)
    ms, mb = randn(B, DIM, dtype=torch.float32, std=0.1), \
        randn(B, DIM, dtype=torch.float32, std=0.1)
    w = (1 + randn(DIM, dtype=torch.float32, std=0.1)).bfloat16()
    bias = randn(DIM, std=0.1)
    cosF, sinF = fn.rope_cos_sin_full(rope_freqs_3d(21, 30, 52, DH, device=dev))
    q, k, v = randn(B, L, HEADS, DH), randn(B, L, HEADS, DH), randn(B, L, HEADS, DH)
    kt, vt = randn(B, TEXT, HEADS, DH), randn(B, TEXT, HEADS, DH)
    _, lut, topk = get_block_map(q, k, TOPK, BQ, BK)
    scale = DH ** -0.5

    # the fused sagesla operands, as sla_attention_fused builds them
    hp = dict(num_heads=HEADS, eps=1e-6, pad_to=LP)
    q_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BQ, quant=True,
                  bf16_out=False)
    k_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BK)
    xq, xk, xv = x, randn(B, L, DIM), randn(B, L, DIM)
    Qp = sf.head_planes_plain(xq, **q_form, **hp)
    Kp = sf.head_planes_plain(xk, **k_form, **hp)
    Vp = sf.head_planes_plain(xv, **hp)
    lut8, sel, k_mean = sf.block_map_from_pooled(Qp["pooled"], Kp["pooled"],
                                                 L, BK, TOPK)
    vi, vcs = si8.quantize_v_per_channel(Vp["bf16"], L)
    kp, vtp, ksb, kv, ksum = sf.subquant_pack_kvt_plain(
        Kp["bf16"], k_mean, vi, BK, L, linear_kv=True)
    proj_w = randn(DH, DH, dtype=torch.float32, std=0.3 / math.sqrt(DH))
    lin = dict(lin_kvw=torch.matmul(kv * vcs, proj_w.t()),
               lin_ks_bias=torch.cat([ksum, randn(B, HEADS, 1, DH,
                                                  dtype=torch.float32,
                                                  std=0.1)], dim=2))
    i8_args = (Qp["i8"], Qp["scale"], kp, vtp, ksb, vcs, lut8)
    i8_kw = dict(block_q=BQ, block_k=BK, kv_len=L)

    def k7(fn_, **extra):
        return lambda: fn_(*i8_args, scale, BQ, BK, L, extra.get("lin_kvw"),
                           extra.get("lin_ks_bias"))

    checks = [
        ("K1", "mod (norm1/norm2)", lambda: fn._mln_cuda(x, ms, mb, None, None, 1e-6),
         lambda: fn.modulated_layer_norm_ref(x, ms, mb, None, None, 1e-6)),
        ("K1", "affine (norm3)", lambda: fn._mln_cuda(x, None, None, w, bias, 1e-6),
         lambda: fn.modulated_layer_norm_ref(x, None, None, w, bias, 1e-6)),
        ("K1", "plain", lambda: fn._mln_cuda(x, None, None, None, None, 1e-6),
         lambda: fn.modulated_layer_norm_ref(x, None, None, None, None, 1e-6)),
        ("K2", "rope (self q/k)",
         lambda: fn._rmsrope_cuda(x, w, cosF, sinF, 1e-6, HEADS),
         lambda: fn.rmsnorm_rope_ref(x, w, cosF, sinF, 1e-6)),
        ("K2", "norm only (cross q)",
         lambda: fn._rmsrope_cuda(x, w, None, None, 1e-6, HEADS),
         lambda: fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH)),
        ("K3", f"sparse topk {TOPK} ({topk}/128 blocks) {BQ}/{BK}",
         lambda: fa._sparse_flash_cuda(q, k, v, lut, BQ, BK, scale, L),
         lambda: fa.sparse_flash_attention_plain(q, k, v, lut, BQ, BK, scale, L)),
        ("K4", f"cross {L}x{TEXT}",
         lambda: fa._flash_cuda(q, kt, vt, scale, TEXT),
         lambda: fa.flash_attention_plain(q, kt, vt, scale, TEXT)),
        ("K4", f"dense self {L}x{L}",
         lambda: fa._flash_cuda(q, k, v, scale, L),
         lambda: fa.flash_attention_plain(q, k, v, scale, L)),
        ("K5", "Q (norm+rope, int8, pool 512)",
         lambda: sf._head_planes_cuda(xq, q_form["weight"], cosF, sinF, HEADS,
                                      1e-6, BQ, True, False, LP),
         lambda: sf.head_planes_plain(xq, **q_form, **hp)),
        ("K5", "K (norm+rope, bf16, pool 256)",
         lambda: sf._head_planes_cuda(xk, w, cosF, sinF, HEADS, 1e-6, BK,
                                      False, True, LP),
         lambda: sf.head_planes_plain(xk, **k_form, **hp)),
        ("K5", "V (bf16 fold)",
         lambda: sf._head_planes_cuda(xv, None, None, None, HEADS, 1e-6, 0,
                                      False, True, LP),
         lambda: sf.head_planes_plain(xv, **hp)),
        ("K6", f"pack K/V {BK}-row blocks",
         lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, False),
         lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L)),
        ("K6", "pack + linear kv sums",
         lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, True),
         lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L,
                                            linear_kv=True)),
        ("K7", f"int8 sparse ({sel}/{LP // BK} blocks) {BQ}/{BK}",
         k7(si8._sparse_i8_vt_cuda),
         lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw)),
        ("K7", "int8 sparse + linear epilogue",
         k7(si8._sparse_i8_vt_cuda, **lin),
         lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw, **lin)),
    ]
    results = {}
    for name, what, kern, plain in checks:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        max_err, mean_err, lsb = _compare(f"{name} {what}", got, want, ATOL, RTOL)
        ms_k = _time_ms(kern, reps)
        ms_p = _time_ms(plain, max(2, reps // 2))
        print(f"phase2 {name} {what}: max_abs_err {max_err:.5g} mean_abs_err "
              f"{mean_err:.5g} int8 max diff {lsb} LSB (tol atol {ATOL} + "
              f"rtol {RTOL}, 1 LSB) | kernel {ms_k:.4f} ms | plain "
              f"{ms_p:.4f} ms", flush=True)
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms_k,
                                      "plain_ms": ms_p})
        r["max_abs_err"] = max(r["max_abs_err"], max_err)
    _poisoned_tail(i8_args, scale)
    return results


def _poisoned_tail(i8_args, scale):
    """K7 on the card: int8 K / V rows past kv_len set to +127 change no
    output row before kv_len (flash_pallas.py:933, the garbage-tail test)."""
    import torch
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    qi, qs, kp, vtp, ksb, vcs, lut8 = i8_args
    clean = si8._sparse_i8_vt_cuda(*i8_args, scale, BQ, BK, L, None, None)
    pk, pv = kp.clone(), vtp.clone()
    pk[:, :, L:] = 127
    pv[:, :, -1, :, L % BK:] = 127
    poisoned = si8._sparse_i8_vt_cuda(qi, qs, pk, pv, ksb, vcs, lut8, scale,
                                      BQ, BK, L, None, None)
    torch.cuda.synchronize()
    if not torch.equal(clean[:, :, :L], poisoned[:, :, :L]):
        raise AssertionError("K7: a poisoned tail changed live rows")
    print(f"phase2 K7 poisoned tail (rows {L}..{LP - 1} = 127): live rows "
          f"unchanged", flush=True)


def _random_block(cfg, dev, seed: int, proj_l_std: float = 0.0):
    """A 1.3B WanAttentionBlock with seeded random non-zero weights; proj_l
    is N(0, proj_l_std^2) (zero, as load_dit finds random weights, at 0)."""
    import torch
    from turbodiffusion_tpu_torch.models.wan import WanAttentionBlock
    blk = WanAttentionBlock(cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "proj_l" in name:
                p.copy_(proj_l_std * torch.randn(p.shape, generator=g, device=dev))
            elif p.dim() == 2 and "modulation" not in name:
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        / math.sqrt(p.shape[1]))
            elif name.endswith(("norm_q", "norm_k", "norm3_weight")):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g, device=dev))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    return blk


def phase3(attention: str, device: str = "cuda"):
    """One full-width block, card against CPU. sla: zero proj_l (the sparse
    branch alone); sagesla: a non-zero proj_l, so K6 sums the linear kv and
    K7 runs its linear epilogue."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rope_cos_sin_full, rmsnorm_rope)
    from turbodiffusion_tpu_torch.ops.sla_fused import (
        block_map_from_pooled, head_planes)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg("Wan2.1-1.3B", attention, TOPK)
    fused = attention == "sagesla"
    if not fused:
        cfg = cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                        linear_branch=False))
    a = cfg.attention
    dev = torch.device(device)
    blk = _random_block(cfg, dev, seed=1, proj_l_std=0.05 if fused else 0.0).eval()
    blk_cpu = copy.deepcopy(blk).cpu()
    g = torch.Generator(device=dev).manual_seed(2)
    T, Hs, Ws = 1, 30, 52
    n = T * Hs * Ws
    x = torch.randn((1, n, DIM), generator=g, device=dev).bfloat16()
    e0 = 0.1 * torch.randn((1, 6, DIM), generator=g, device=dev)
    ctx = torch.randn((1, TEXT, DIM), generator=g, device=dev).bfloat16()
    rope = rope_cos_sin_full(rope_freqs_3d(T, Hs, Ws, DH, device=dev))

    def block_map(b, x, e0, rope):
        e = b.modulation.float()[None] + e0
        h = modulated_layer_norm(x, e[:, 1:2], e[:, 0:1], eps=cfg.eps)
        sa = b.self_attn
        if fused:
            kw = dict(num_heads=HEADS, eps=cfg.eps, pad_to=-(-n // 512) * 512)
            pq = head_planes(sa.q(h), sa.norm_q, *rope, pool=a.block_q,
                             quant=True, bf16_out=False, **kw)["pooled"]
            pk = head_planes(sa.k(h), sa.norm_k, *rope, pool=a.block_k,
                             **kw)["pooled"]
            return block_map_from_pooled(pq, pk, n, a.block_k, a.sla_topk)[0]
        q = rmsnorm_rope(sa.q(h), sa.norm_q, *rope, num_heads=HEADS, eps=cfg.eps)
        k = rmsnorm_rope(sa.k(h), sa.norm_k, *rope, num_heads=HEADS, eps=cfg.eps)
        return get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]

    cpu_args = (x.cpu(), e0.cpu(), tuple(t.cpu() for t in rope))
    with torch.no_grad():
        lut_gpu = block_map(blk, x, e0, rope).cpu()
        lut_cpu = block_map(blk_cpu, *cpu_args)
        same = (lut_gpu.sort(-1).values == lut_cpu.sort(-1).values).all(-1)
        bad_q = sorted(set((~same).nonzero()[:, 2].tolist()))
        t0 = time.perf_counter()
        out = blk(x, e0, rope, ctx)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms_gpu = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = blk_cpu(*cpu_args, ctx.cpu())
        ms_cpu = (time.perf_counter() - t0) * 1e3
    keep = torch.ones(n, dtype=torch.bool)
    for i in bad_q:
        keep[i * a.block_q:(i + 1) * a.block_q] = False
    if not keep.any():
        raise AssertionError(f"phase3 {attention}: every Q-block's LUT differs")
    max_err, mean_err, _ = _compare(f"phase3 {attention} block",
                                    out.cpu()[:, keep], ref[:, keep],
                                    BLOCK_ATOL, BLOCK_RTOL)
    print(f"phase3 1.3B {attention} block L={n}"
          f"{' (proj_l != 0, linear epilogue on)' if fused else ''}: LUT rows "
          f"equal as sets {int(same.sum())}/{same.numel()} (Q-blocks left out "
          f"of the comparison: {bad_q}) | max_abs_err {max_err:.5g} "
          f"mean_abs_err {mean_err:.5g} (tol atol {BLOCK_ATOL} + rtol "
          f"{BLOCK_RTOL}) | card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms",
          flush=True)


def phase4(attention: str, requests: int):
    """`requests` 480p/81f requests through WanPipeline.create(attention_type=
    attention), then a traced denoise (`_profile_denoise`); returns the
    launch counts of the last request."""
    import torch
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    launchers = _launchers()
    want = EXPECTED_LAUNCHES[attention]
    t0 = time.perf_counter()
    pipe = WanPipeline.create(model="Wan2.1-1.3B", attention_type=attention,
                              sla_topk=TOPK, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"phase4 {attention} create: {time.perf_counter() - t0:.1f} s, "
          f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    counts = None
    for r in range(requests):
        gen = GenerationConfig(num_steps=4, num_frames=81, resolution="480p",
                               aspect_ratio="16:9", seed=r)
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        for fn in launchers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        video = pipe.generate_t2v("a red fox running through snow", gen,
                                  timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in launchers.items()}
        if counts != want:
            raise AssertionError(f"{attention} launch counts {counts} != {want}")
        if tuple(video.shape) != (1, 3, 81, 480, 832):
            raise AssertionError(f"video shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        lo, hi = float(video.min()), float(video.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"video outside [0, 1]: [{lo}, {hi}]")
        print(f"phase4 {attention} request {r}: text-encode "
              f"{timings['text_encode_ms']:.1f} ms | denoise "
              f"{timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | video "
              f"{tuple(video.shape)} in [{lo:.3f}, {hi:.3f}] | launches "
              f"{counts}", flush=True)
    _profile_denoise(pipe)
    del pipe
    torch.cuda.empty_cache()
    return counts


# kernel-name substrings -> category, first match wins
PROFILE_CATEGORIES = [
    ("K1", ("mln_kernel",)), ("K2", ("rmsrope_kernel",)),
    ("K3", ("flash_fwd_kernel<true>",)), ("K4", ("flash_fwd_kernel<false>",)),
    ("K5", ("head_planes_kernel",)), ("K6", ("subquant_pack_kvt_kernel",)),
    ("K6 linear kv", ("linear_kv_",)), ("K7", ("sparse_i8_vt_kernel",)),
    ("GEMM", ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")),
    ("top-k/sort", ("topk", "sort", "radix")), ("reduce", ("reduce",)),
]


def _profile_denoise(pipe):
    """The denoise phase of one warm request (4 DiT calls at 480p/81f) under
    torch.profiler: device time by kernel category and the device's idle
    share, as one printed line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.sampler import latent_shape
    gen = GenerationConfig(num_frames=81, resolution="480p", aspect_ratio="16:9")
    emb = pipe.text_encoder("a red fox running through snow").to(pipe.cfg.dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, *latent_shape(gen)), generator=g, device="cuda")
    t = torch.full((1, 1), 500.0, device="cuda")
    with torch.no_grad():
        pipe.dit(x, t, emb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(gen.num_steps):
                pipe.dit(x, t, emb)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0 if cur_e is None else cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    cats = {}
    for e in kernels:
        name = e.name
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "elementwise/copy/other")
        cats[cat] = cats.get(cat, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(cats.values()) or 1.0
    parts = ", ".join(f"{c} {us / 1e3:.1f} ms ({100 * us / total:.1f}%)"
                      for c, us in sorted(cats.items(), key=lambda kv: -kv[1]))
    line = (f"phase4 {pipe.cfg.attention.backend} profile, denoise 4 DiT calls: "
            f"wall {wall:.1f} ms, device window {window / 1e3:.1f} ms, idle "
            f"share {1 - busy / window if window else 0:.3f}; kernel time "
            f"{total / 1e3:.1f} ms: {parts}")
    print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated subset; the final ok line needs all")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import turbodiffusion_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = phase1()
    kernels = phase2() if 2 in phases else {}
    if 3 in phases:
        for attention in ("sla", "sagesla"):
            phase3(attention)
    counts = {}
    if 4 in phases:
        # a kernel's launches come from the first path that runs it: this
        # slice's main path (sagesla), then the earlier one (sla)
        for attention, n in REQUESTS.items():
            for name, c in phase4(attention, n).items():
                counts[name] = counts.get(name) or c
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts.get(n, 0), **kernels.get(n, {})}
        for n, (src, rep) in KERNELS.items()]}))
    print(smi)
    if phases != {1, 2, 3, 4}:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
