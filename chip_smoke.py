"""Smoke run of the PyTorch port (`turbodiffusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --phases 1,2

Phases, each printing one line of its numbers:
  1. device and build: the card's name and power limit (nvidia-smi), and the
     time to build the CUDA kernels from `turbodiffusion_tpu_torch/csrc/`;
  2. every kernel of the main path against its plain PyTorch version on the
     card, at the main path's shapes (Wan2.1-1.3B, 480p/81f: 32,760 tokens,
     12 heads x 128, dim 1536, 512 text tokens), in bf16: max and mean
     absolute error under the stated tolerance, and both times (CUDA events,
     median of a few runs);
  3. one full-width 1.3B `WanAttentionBlock` with seeded random non-zero
     weights at one 480p latent frame (1,560 tokens): the kernels on the card
     against the plain versions on the CPU, after comparing the two block maps;
  4. the slice: `WanPipeline.create(..., attention_type="sla")` with random
     weights, then two 480p/81f 4-step `generate_t2v` requests; per request the
     text-encode, denoise and VAE-decode times, peak device memory, and the
     launch count of every kernel (3, 3, 1 and 1 per block x 30 blocks x 4
     steps), which shows the path went through each of them.
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
EXPECTED_LAUNCHES = {"K1": 360, "K2": 360, "K3": 120, "K4": 120}
REPS = 5          # timed runs of each kernel (plain versions: REPS // 2)
REQUESTS = 2      # phase-4 requests on the resident pipeline

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
}


def _launchers():
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    return {"K1": fn._mln_cuda, "K2": fn._rmsrope_cuda,
            "K3": fa._sparse_flash_cuda, "K4": fa._flash_cuda}


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
    import torch
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
    return max_err, mean_err


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
    _, lut, topk = get_block_map(q, k, 0.1, 512, 256)
    scale = DH ** -0.5

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
        ("K3", f"sparse topk 0.1 ({topk}/128 blocks) 512/256",
         lambda: fa._sparse_flash_cuda(q, k, v, lut, 512, 256, scale, L),
         lambda: fa.sparse_flash_attention_plain(q, k, v, lut, 512, 256, scale, L)),
        ("K4", f"cross {L}x{TEXT}",
         lambda: fa._flash_cuda(q, kt, vt, scale, TEXT),
         lambda: fa.flash_attention_plain(q, kt, vt, scale, TEXT)),
        ("K4", f"dense self {L}x{L}",
         lambda: fa._flash_cuda(q, k, v, scale, L),
         lambda: fa.flash_attention_plain(q, k, v, scale, L)),
    ]
    results = {}
    for name, what, kern, plain in checks:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        max_err, mean_err = _compare(f"{name} {what}", got, want, ATOL, RTOL)
        ms_k = _time_ms(kern, reps)
        ms_p = _time_ms(plain, max(2, reps // 2))
        print(f"phase2 {name} {what}: max_abs_err {max_err:.5g} mean_abs_err "
              f"{mean_err:.5g} (tol atol {ATOL} + rtol {RTOL}) | kernel "
              f"{ms_k:.4f} ms | plain {ms_p:.4f} ms", flush=True)
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms_k,
                                      "plain_ms": ms_p})
        r["max_abs_err"] = max(r["max_abs_err"], max_err)
    return results


def _random_block(cfg, dev, seed: int):
    """A 1.3B WanAttentionBlock with seeded random non-zero weights."""
    import torch
    from turbodiffusion_tpu_torch.models.wan import WanAttentionBlock
    blk = WanAttentionBlock(cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "proj_l" in name:
                p.zero_()
            elif p.dim() == 2 and "modulation" not in name:
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        / math.sqrt(p.shape[1]))
            elif name.endswith(("norm_q", "norm_k", "norm3_weight")):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g, device=dev))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    return blk


def phase3(device: str = "cuda"):
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rope_cos_sin_full, rmsnorm_rope)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg("Wan2.1-1.3B", "sla", 0.1)
    # proj_l is zero, as load_dit would find it: the sparse branch alone
    cfg = cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                    linear_branch=False))
    a = cfg.attention
    dev = torch.device(device)
    blk = _random_block(cfg, dev, seed=1).eval()
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
        raise AssertionError("phase3: every Q-block's LUT differs")
    max_err, mean_err = _compare("phase3 block", out.cpu()[:, keep],
                                 ref[:, keep], BLOCK_ATOL, BLOCK_RTOL)
    print(f"phase3 1.3B block L={n}: LUT rows equal as sets "
          f"{int(same.sum())}/{same.numel()} (Q-blocks left out of the "
          f"comparison: {bad_q}) | max_abs_err {max_err:.5g} mean_abs_err "
          f"{mean_err:.5g} (tol atol {BLOCK_ATOL} + rtol {BLOCK_RTOL}) | "
          f"card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms", flush=True)


def phase4(requests: int = REQUESTS):
    import torch
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    launchers = _launchers()
    t0 = time.perf_counter()
    pipe = WanPipeline.create(model="Wan2.1-1.3B", attention_type="sla",
                              sla_topk=0.1, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"phase4 create: {time.perf_counter() - t0:.1f} s, resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
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
        if counts != EXPECTED_LAUNCHES:
            raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")
        if tuple(video.shape) != (1, 3, 81, 480, 832):
            raise AssertionError(f"video shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        lo, hi = float(video.min()), float(video.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"video outside [0, 1]: [{lo}, {hi}]")
        print(f"phase4 request {r}: text-encode {timings['text_encode_ms']:.1f} ms"
              f" | denoise {timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | video "
              f"{tuple(video.shape)} in [{lo:.3f}, {hi:.3f}] | launches "
              f"{counts}", flush=True)
    return counts


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
        phase3()
    counts = phase4() if 4 in phases else {}
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
