"""Smoke run of the PyTorch port (`turbodiffusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --phases 1,2

Phases, each printing one line of its numbers:
  1. device and build: the card's name and power limit (nvidia-smi), and the
     time to build the CUDA kernels from `turbodiffusion_tpu_torch/csrc/`;
  2. every kernel of the paths against its plain PyTorch version on the
     card, at the paths' shapes (480p/81f: 32,760 tokens, 512 text tokens,
     heads of 128, sagesla blocks 512/256; Wan2.1-1.3B: 12 heads, dim 1536,
     FFN 8960, 12 of 128 K blocks; K12 also at batch 2 with the block's
     strided modulation; K18 and K19 of the v_quant="row" path,
     K20 at blocks 64/64 with 51 of 512 K blocks, K21 over the planes and
     over (B, L, H, D); then the Wan2.1-14B forms: K15, K5 with K15's RMS
     at 40 heads, K6, K7, K16, K17, K12 and K8-K11 at dim 5120, FFN 13824),
     with poisoned-tail checks of K7, K19 and K21: max absolute error
     under the stated tolerance (int8 outputs within 1 LSB; K19-K21 at
     atol 4e-3 + rtol 2e-2, each with planted faults the check must
     reject: a dropped LUT entry, K21's weight zeroed, v read from k, q
     doubled), the mean and max |output| beside it, both times
     (CUDA events, median of a few runs), the least time the card could
     take (`bound`: bytes over 3.35 TB/s or operations over the dense peak
     of their type, whichever is larger) and, where one PyTorch call
     computes the same function, that call's time (`library`; for the int8
     GEMMs `torch._int_mm`, the product alone, plus bf16 `torch.matmul` of
     the same shape); the port calls neither;
  3. one full-width `WanAttentionBlock` with seeded random non-zero weights
     at one 480p latent frame (1,560 tokens): at 1.3B `sla`, `sagesla`,
     `sagesla` with W8A8 linears and `sla` with W8A8 linears (the sagesla
     blocks with a non-zero `proj_l`, so the fused linear epilogue runs; the
     W8A8 blocks take the int8 feeds K12-K14), W8A8 `sagesla` at
     v_quant="row" with a non-zero `proj_l` (K18, K19, K21 over the planes),
     W8A8 `sagesla` at blocks 64/64 (K20), bf16 `sla` with a non-zero
     `proj_l` (K21 over (B, L, H, D)) and W8A8 `sagesla` at batch 2, and at
     14B `sagesla` with W8A8 linears (unfused Q / K / V, K15-K17): the
     kernels on the card against the plain versions on the CPU, on the Q
     blocks whose block-map rows agree as sets, with each block's launch
     counts (K21's in the JSON line: random weights give the requests a
     zero `proj_l`);
  4. the paths: `WanPipeline.create(..., attention_type="sagesla",
     quant_linear=True)` with random weights and two 480p/81f 4-step
     `generate_t2v` requests, then one request each of bf16 `sagesla` and
     `sla`, one W8A8 `sagesla` request at v_quant="row" and one at
     sla_block=64, then, with the 1.3B pipelines freed, two requests of
     `WanPipeline.create("Wan2.1-14B", quant_linear=True)`; per request the
     text-encode, denoise and VAE-decode times, peak device memory, and the
     launch count of every kernel, set to 0 just before the request and
     read just after (1.3B W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 6, K10
     1, K11 1, K12 3, K13 1, K14 1 per block; bf16 sagesla: K1 3, K2 1, K4
     1, K5 3, K6 1, K7 1; sla: K1 3, K2 3, K3 1, K4 1; W8A8 row: K5 3, K8 2,
     K9 6, K10 1, K11 1, K12 3, K13 1, K14 1, K18 1, K19 1; W8A8 block 64:
     K2 2, K8 3, K9 6, K10 1, K11 1, K12 3, K14 1, K20 1; x 30 blocks x 4
     steps; 14B W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 8, K10 1, K11 1,
     K12 3, K15 3, K16 1, K17 1 x 40 blocks x 4 steps; every other kernel
     0), which shows each path went through its kernels; then each path's
     denoise under torch.profiler: device time by kernel category and the
     device's idle share.
Then one JSON line with every kernel's numbers (a kernel the 14B path runs:
its 14B checks and that path's launches; K21: its 1.3B checks and the
launches of the phase-3 block that runs it over the planes; any other: its
1.3B checks and the launches of the first 1.3B path that runs it), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}. Any
failure raises and the script exits non-zero; without a CUDA card it exits
non-zero at once.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One model's widths (config.py presets): `bnq` is K10's scale block
    and K11's K slab, pick_bn_div(ffn); Q, K and V are one fused linear
    below dim 4096."""
    model: str
    dim: int
    heads: int
    ffn: int
    bnq: int

    @property
    def fuse_qkv(self) -> bool:
        return self.dim < 4096


G13 = Geometry("Wan2.1-1.3B", 1536, 12, 8960, 896)
G14 = Geometry("Wan2.1-14B", 5120, 40, 13824, 768)
# 480p/81f: tokens, head dim, text tokens
B, L, DH, TEXT = 1, 32760, 128, 512
ATOL, RTOL = 2e-2, 2e-2           # bf16 kernel vs plain version on the card
# K19-K21: outputs of order 0.03 (K19, K20: near-flat softmax over ~3,000
# keys) to 1 (K21's inputs); an atol a fifth of ATOL fails each planted fault
SHARP_ATOL = 4e-3
SCALE_RTOL = 1e-5                   # fp32 int8 scales, kernel vs plain
# K14's scales: its fp32 sums (the row's mean square, QK, P V) run in another
# order than the plain version's, which can move one bf16 element of the
# normed q or of P by a step (2^-8) and so the row's output absmax by up to
# ~p_j * 2^-8 / l of it (a few 1e-3 where one key dominates the row)
K14_SCALE_RTOL = 5e-3
BLOCK_ATOL, BLOCK_RTOL = 0.1, 0.05  # bf16 block, card vs CPU (other GEMMs)
BQ, BK, TOPK = 512, 256, 0.1        # sagesla / sla blocks and top-k ratio
LP = -(-L // 512) * 512             # the fused path's padded length
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): a
# kernel's bound is the larger of its bytes over HBM and the sum over types
# of its operations over the type's peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# launches per request: blocks x 4 steps x per-block calls (1.3B: 30
# blocks, 14B: 40); a kernel a path does not name runs 0 times
_SAGESLA = {"K5": 360, "K6": 120, "K7": 120}
EXPECTED_LAUNCHES = {
    # the int8 feeds: K12 for norm1 / norm3 / norm2, K13 for the O feed, K14
    # for cross attention; K8 only for the text-side K / V linears
    "sagesla+w8a8": {**_SAGESLA, "K8": 240, "K9": 720, "K10": 120,
                     "K11": 120, "K12": 360, "K13": 120, "K14": 120},
    "sagesla": {**_SAGESLA, "K1": 360, "K2": 120, "K4": 120},
    "sla": {"K1": 360, "K2": 360, "K3": 120, "K4": 120},
    # v_quant="row": K5's V pass gives per-row int8, K18 packs, K19 attends
    "sagesla+w8a8 row": {"K5": 360, "K8": 240, "K9": 720, "K10": 120,
                         "K11": 120, "K12": 360, "K13": 120, "K14": 120,
                         "K18": 120, "K19": 120},
    # blocks 64/64: the composable path, K2 on q and k, K20; the O
    # projection takes K8 on the bf16 attention output
    "sagesla+w8a8 block64": {"K2": 240, "K8": 360, "K9": 720, "K10": 120,
                             "K11": 120, "K12": 360, "K14": 120, "K20": 120},
    # the wide forms: unfused Q / K / V (K9 x 8), K15 on Q, K and the cross
    # q, K5 reading its RMS, K16 for the O feed, K17 for cross attention
    "14b-sagesla+w8a8": {"K5": 480, "K6": 160, "K7": 160, "K8": 320,
                         "K9": 1280, "K10": 160, "K11": 160, "K12": 480,
                         "K15": 480, "K16": 160, "K17": 160},
}
REPS = 5          # timed runs of each kernel (plain versions: REPS // 2)
# phase-4 paths in the order run: (label, geometry, attention, quant_linear,
# requests, other WanPipeline.create arguments); the 14B runs last, after
# the 1.3B pipelines are freed, and its counts fill the JSON line first
PATHS = [("sagesla+w8a8", G13, "sagesla", True, 2, {}),
         ("sagesla", G13, "sagesla", False, 1, {}),
         ("sla", G13, "sla", False, 1, {}),
         ("sagesla+w8a8 row", G13, "sagesla", True, 1, {"v_quant": "row"}),
         ("sagesla+w8a8 block64", G13, "sagesla", True, 1, {"sla_block": 64}),
         ("14b-sagesla+w8a8", G14, "sagesla", True, 2, {})]

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
    "K8": ("turbodiffusion_tpu_torch/csrc/quant.cu",
           "turbodiffusion_tpu/ops/quant.py:121"),
    "K9": ("turbodiffusion_tpu_torch/csrc/quant.cu",
           "turbodiffusion_tpu/ops/quant.py:253"),
    "K10": ("turbodiffusion_tpu_torch/csrc/quant.cu",
            "turbodiffusion_tpu/ops/quant.py:561"),
    "K11": ("turbodiffusion_tpu_torch/csrc/quant.cu",
            "turbodiffusion_tpu/ops/quant.py:750"),
    "K12": ("turbodiffusion_tpu_torch/csrc/fused_norm.cu",
            "turbodiffusion_tpu/ops/fused_norm.py:144"),
    "K13": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:633"),
    "K14": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:384"),
    "K15": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:62"),
    "K16": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:608"),
    "K17": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:310"),
    "K18": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:501"),
    "K19": ("turbodiffusion_tpu_torch/csrc/sparse_i8_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1432"),
    "K20": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1200"),
    "K21": ("turbodiffusion_tpu_torch/csrc/linear_attention.cu",
            "turbodiffusion_tpu/ops/linear_attention_pallas.py:141"),
}


def _launchers():
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    from turbodiffusion_tpu_torch.ops import quant as qt
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    return {"K1": fn._mln_cuda, "K2": fn._rmsrope_cuda,
            "K3": fa._sparse_flash_cuda, "K4": fa._flash_cuda,
            "K5": sf._head_planes_cuda, "K6": sf._subquant_pack_kvt_cuda,
            "K7": si8._sparse_i8_vt_cuda, "K8": qt._quantize_rows_cuda,
            "K9": qt._int8_gemm_postscale_cuda, "K10": qt._int8_gemm_qout_cuda,
            "K11": qt._int8_gemm_blockact_cuda, "K12": fn._mln_quant_cuda,
            "K13": sf._unfold_quant_cuda, "K14": fa._cross_qout_cuda,
            "K15": sf._row_rms_inv_cuda, "K16": sf._unfold_quant_wide_cuda,
            "K17": fa._cross_qout_wide_cuda, "K18": sf._subquant_pack_kv_cuda,
            "K19": si8._sparse_i8_planes_cuda, "K20": fa._sparse_flash_i8qk_cuda,
            "K21": la._linear_projected_cuda}


@dataclasses.dataclass
class Check:
    """One phase-2 comparison: the kernel launcher and its plain version on
    the same inputs; `ins` are the tensors the kernel reads (each counted
    once in its bound, with its outputs written once), `ops` its operations
    by type; `library` one PyTorch call computing the same function, where
    there is one, and `yardsticks` other calls timed beside it; `faults`
    planted faults (what -> a wrong output, from the kernel on altered
    inputs) that the comparison must reject."""
    name: str
    what: str
    kern: object
    plain: object
    ins: tuple
    ops: dict
    library: object = None
    library_what: str = ""
    yardsticks: dict = dataclasses.field(default_factory=dict)
    atol: float = ATOL
    rtol: float = RTOL
    faults: dict = dataclasses.field(default_factory=dict)


def _nbytes(t) -> int:
    if t is None:
        return 0
    if isinstance(t, dict):
        return sum(_nbytes(v) for v in t.values())
    if isinstance(t, (tuple, list)):
        return sum(_nbytes(v) for v in t)
    return t.numel() * t.element_size()


def _bound(nbytes: int, ops: dict):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sparse_pairs(lut, block_q: int, block_k: int, lq: int, kv_len: int) -> int:
    """Query-key pairs a block-sparse pass computes with these inputs: for
    each (b, h, Q block), its valid query rows times the valid keys of the
    K blocks its LUT row selects."""
    import torch
    nq = lut.shape[2]
    q_rows = (lq - torch.arange(nq, device=lut.device) * block_q).clamp(max=block_q)
    k_rows = (kv_len - lut.long() * block_k).clamp(min=0, max=block_k)
    return int((k_rows.sum(-1) * q_rows).sum())


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
    """(max abs error, mean abs error, int8 LSB difference, mean |want|,
    max |want|); raises past atol + rtol * |want|, or past 1 LSB for int8
    outputs. Tuples and dicts compare element by element and give the worst
    (largest) of each."""
    import torch
    if isinstance(got, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: outputs {sorted(got)} != {sorted(want)}")
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]
    if isinstance(got, (tuple, list)):
        errs = [_compare(name, a, b, atol, rtol) for a, b in zip(got, want)]
        return tuple(max(e[i] for e in errs) for i in range(5))
    if got.dtype == torch.int8:
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        d = int((got.int() - want.int()).abs().max())
        if d > 1:
            raise AssertionError(f"{name}: int8 output off by {d} LSB")
        wa = want.float().abs()
        return 0.0, 0.0, d, float(wa.mean()), float(wa.max())
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
    return max_err, mean_err, 0, float(want.abs().mean()), float(want.abs().max())


def phase1():
    from turbodiffusion_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = _build.load()
    wall = time.perf_counter() - t0
    print(f"phase1 device: {smi} | kernel build {lib.build_seconds:.1f} s "
          f"(load {wall:.1f} s) | ptxas: {_ptxas_summary(lib.build_log)}",
          flush=True)
    return smi


def _kernel_name(mangled: str) -> str:
    """`head_planes_kernel<4>` from the mangled name of a kernel in a
    (per-file anonymous) namespace, its bool / int template arguments
    decoded."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]          # past the namespace
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    n, rest = int(m.group(1)), rest[m.end():]
    name, args = rest[:n], re.match(r"I((?:L[bi]\d+E)+)E", rest[n:])
    if args:
        vals = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
        name += f"<{', '.join(vals)}>"
    return name


def _ptxas_summary(log: str) -> str:
    """`kernel<args> N regs[, S B spill]` for each kernel entry of nvcc's
    -Xptxas -v output (empty when nothing was built in this process)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name and int(m.group(1)):
            spill = f", {m.group(1)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs{spill}")
            name = None
    return "; ".join(out)


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

    DIM, HEADS = G13.dim, G13.heads
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

    def sdpa(q_, k_, v_):
        # (B, L, H, Dh) views as (B, H, L, Dh), as the kernel reads them
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2))

    # operations by type; the elementwise kernels count their few fp32
    # operations per element (they are bound by bytes by a wide margin)
    n_x = x.numel()
    F_rms_norm = getattr(torch.nn.functional, "rms_norm", None)  # torch >= 2.4
    pairs3 = _sparse_pairs(lut, BQ, BK, L, L)
    pairs7 = _sparse_pairs(lut8, BQ, BK, L, L)
    ops4 = lambda lk: {"bf16": 4 * B * HEADS * L * lk * DH}      # noqa: E731
    ops7 = {"int8": 2 * DH * pairs7, "bf16": 2 * DH * pairs7}   # QK, PV
    kv_ops = 2 * B * HEADS * L * DH * DH                          # K6's kv sums
    checks = [
        # the main path's K1 forms: norm1/norm2 (mod) twice a block, norm3
        # (affine) once; the affine form first, as F.layer_norm computes it
        Check("K1", "affine (norm3)", lambda: fn._mln_cuda(x, None, None, w, bias, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, None, None, w, bias, 1e-6),
              (x, w, bias), {"fp32": 8 * n_x},
              lambda: torch.nn.functional.layer_norm(x, (DIM,), w, bias, 1e-6),
              "F.layer_norm"),
        Check("K1", "mod (norm1/norm2)", lambda: fn._mln_cuda(x, ms, mb, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, ms, mb, None, None, 1e-6),
              (x, ms, mb), {"fp32": 8 * n_x}),
        Check("K1", "plain", lambda: fn._mln_cuda(x, None, None, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, None, None, None, None, 1e-6),
              (x,), {"fp32": 6 * n_x},
              lambda: torch.nn.functional.layer_norm(x, (DIM,), eps=1e-6),
              "F.layer_norm"),
        # sagesla's K2 form (cross q) first
        Check("K2", "norm only (cross q)",
              lambda: fn._rmsrope_cuda(x, w, None, None, 1e-6, HEADS),
              lambda: fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH),
              (x, w), {"fp32": 4 * n_x},
              (lambda: F_rms_norm(x, (DIM,), w, 1e-6)) if F_rms_norm else None,
              "F.rms_norm"),
        Check("K2", "rope (self q/k)",
              lambda: fn._rmsrope_cuda(x, w, cosF, sinF, 1e-6, HEADS),
              lambda: fn.rmsnorm_rope_ref(x, w, cosF, sinF, 1e-6),
              (x, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x}),
        Check("K3", f"sparse topk {TOPK} ({topk}/128 blocks) {BQ}/{BK}",
              lambda: fa._sparse_flash_cuda(q, k, v, lut, BQ, BK, scale, L),
              lambda: fa.sparse_flash_attention_plain(q, k, v, lut, BQ, BK, scale, L),
              (q, k, v, lut), {"bf16": 4 * DH * pairs3}),
        Check("K4", f"cross {L}x{TEXT}",
              lambda: fa._flash_cuda(q, kt, vt, scale, TEXT),
              lambda: fa.flash_attention_plain(q, kt, vt, scale, TEXT),
              (q, kt, vt), ops4(TEXT), sdpa(q, kt, vt),
              "F.scaled_dot_product_attention"),
        Check("K4", f"dense self {L}x{L}",
              lambda: fa._flash_cuda(q, k, v, scale, L),
              lambda: fa.flash_attention_plain(q, k, v, scale, L),
              (q, k, v), ops4(L), sdpa(q, k, v),
              "F.scaled_dot_product_attention"),
        Check("K5", "Q (norm+rope, int8, pool 512)",
              lambda: sf._head_planes_cuda(xq, q_form["weight"], cosF, sinF, HEADS,
                                           1e-6, BQ, True, False, LP),
              lambda: sf.head_planes_plain(xq, **q_form, **hp),
              (xq, w, cosF[:L], sinF[:L]), {"fp32": 12 * n_x}),
        Check("K5", "K (norm+rope, bf16, pool 256)",
              lambda: sf._head_planes_cuda(xk, w, cosF, sinF, HEADS, 1e-6, BK,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xk, **k_form, **hp),
              (xk, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x}),
        Check("K5", "V (bf16 fold)",
              lambda: sf._head_planes_cuda(xv, None, None, None, HEADS, 1e-6, 0,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xv, **hp), (xv,), {}),
        Check("K6", f"pack K/V {BK}-row blocks",
              lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, False),
              lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L),
              (Kp["bf16"], k_mean, vi), {"fp32": 4 * n_x}),
        Check("K6", "pack + linear kv sums",
              lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, True),
              lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L,
                                                 linear_kv=True),
              (Kp["bf16"], k_mean, vi), {"fp32": 4 * n_x + kv_ops}),
        Check("K7", f"int8 sparse ({sel}/{LP // BK} blocks) {BQ}/{BK}",
              k7(si8._sparse_i8_vt_cuda),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw),
              i8_args, ops7),
        Check("K7", "int8 sparse + linear epilogue",
              k7(si8._sparse_i8_vt_cuda, **lin),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw, **lin),
              i8_args + tuple(lin.values()), ops7),
    ] + _w8a8_checks(randn, x, G13) + _int8_feed_checks(randn, x, ms, mb, w,
                                                       bias, kt, vt, sdpa)
    mode_checks, tails = _mode_checks(randn, Qp, Kp, k_mean, xv, lut8, q, k, v)
    results = _run_checks(checks + mode_checks, reps)
    _poisoned_tail(i8_args, scale)
    for tail in tails:
        tail()
    # a kernel this slice's path (the 14B) runs reports its 14B numbers,
    # with the worst error of all its checks
    for name, r in _run_checks(_wide_checks(randn, sdpa), reps).items():
        worst = max(r["max_abs_err"], results.get(name, r)["max_abs_err"])
        results[name] = {**r, "max_abs_err": worst}
    return results


def _run_checks(checks, reps: int) -> dict:
    """Run each check (compare, bound, times) and print its line; returns
    each kernel's JSON numbers: its first check's, with the worst error of
    all its checks."""
    import torch
    results = {}
    for c in checks:
        got = c.kern()
        want = c.plain()
        torch.cuda.synchronize()
        max_err, mean_err, lsb, want_mean, want_max = _compare(
            f"{c.name} {c.what}", got, want, c.atol, c.rtol)
        bound_ms, bound_by = _bound(_nbytes(c.ins) + _nbytes(got), c.ops)
        for what, fault in c.faults.items():
            _must_fail(f"{c.name} {c.what}", what, fault(), want, c.atol, c.rtol)
        del got, want
        ms_k = _time_ms(c.kern, reps)
        ms_p = _time_ms(c.plain, max(2, reps // 2))
        lib_ms = _time_ms(c.library, reps) if c.library else None
        extra = "".join(f" | {what} {_time_ms(fn_, reps):.4f} ms"
                        for what, fn_ in c.yardsticks.items())
        lib = (f" | library {c.library_what} {lib_ms:.4f} ms" if c.library
               else " | library none")
        print(f"phase2 {c.name} {c.what}: max_abs_err {max_err:.5g} mean_abs_err "
              f"{mean_err:.5g} int8 max diff {lsb} LSB (tol atol {c.atol} + "
              f"rtol {c.rtol}, 1 LSB; |want| mean {want_mean:.5g} max "
              f"{want_max:.5g}) | kernel {ms_k:.4f} ms | plain "
              f"{ms_p:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}){lib}{extra}",
              flush=True)
        # a kernel's line in the JSON: its first check's numbers, the worst
        # error of all its checks
        r = results.setdefault(c.name, {
            "max_abs_err": 0.0, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        r["max_abs_err"] = max(r["max_abs_err"], max_err)
    return results


def _must_fail(name, what, bad, want, atol, rtol):
    """A planted fault: the comparison that passes the kernel must reject
    `bad`, a wrong output of the same shape."""
    import torch
    torch.cuda.synchronize()
    try:
        _compare(name, bad, want, atol, rtol)
    except AssertionError as e:
        print(f"phase2 {name} planted fault ({what}): rejected: {e}", flush=True)
        return
    raise AssertionError(f"{name}: the planted fault ({what}) passed the check")


def _w8a8_checks(randn, x, geo: Geometry):
    """Phase-2 checks of K8-K11 at a W8A8 path's shapes: K8 over the trunk
    and the text context; K9 as the fused QKV (1.3B) or Q (14B, unfused),
    with bias, the O projection (gate + residual) and a text-side cross-K
    (M = 512); K10 as fc1 (GELU, int8 out with per-BN scales); K11 as fc2
    (BN-wide K slabs, gate + residual). Weights are N(0, 1/fan_in) quantised
    as the port quantises them; activations are K8's (plain) output. Beside
    each GEMM: `torch._int_mm` on the same int8 operands (the product alone)
    and bf16 `torch.matmul` of the same shape (what the bf16 path pays)."""
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt

    def weight(n, k):
        return qt.quantize_int8_postscale(randn(n, k, std=k ** -0.5))

    DIM, FFN, BNQ = geo.dim, geo.ffn, geo.bnq
    n_in = 3 * DIM if geo.fuse_qkv else DIM
    x2 = x.reshape(L, DIM)
    c2 = randn(TEXT, DIM)
    xq, rs = qt.quantize_rows_int8_plain(x2)
    cq, crs = qt.quantize_rows_int8_plain(c2)
    (wqkv, sqkv), (wo, so), (wk, sk) = weight(n_in, DIM), weight(DIM, DIM), \
        weight(DIM, DIM)
    (w1, s1), (w2, s2) = weight(FFN, DIM), weight(DIM, FFN)
    bqkv, bk_, b1, b2 = (randn(n, std=0.1) for n in (n_in, DIM, FFN, DIM))
    gate = randn(DIM, dtype=torch.float32, std=0.5)
    hq, hs = qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1, act="gelu_tanh")
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)

    def gemm(name, what, kern, plain, ins, a, wq, **kw):
        M, K = a.shape
        N = wq.shape[0]
        ab, wb = randn(M, K), randn(N, K)
        return Check(name, what, kern, plain, ins, {"int8": 2 * M * N * K},
                     lambda: torch._int_mm(a, wq.t()),
                     "torch._int_mm (product only)",
                     {"bf16 torch.matmul": lambda: torch.matmul(ab, wb.t())}, **kw)

    return [
        Check("K8", f"rows {L}x{DIM}", lambda: qt._quantize_rows_cuda(x2),
              lambda: qt.quantize_rows_int8_plain(x2), (x2,),
              {"fp32": 3 * x2.numel()}, **scale_tol),
        Check("K8", f"text rows {TEXT}x{DIM}", lambda: qt._quantize_rows_cuda(c2),
              lambda: qt.quantize_rows_int8_plain(c2), (c2,),
              {"fp32": 3 * c2.numel()}, **scale_tol),
        gemm("K9", f"{'fused QKV' if geo.fuse_qkv else 'Q'} {L}x{n_in}x{DIM} + bias",
             lambda: qt._int8_gemm_postscale_cuda(xq, rs, wqkv, sqkv, bqkv, None,
                                                  None, None),
             lambda: qt.int8_gemm_postscale_plain(xq, rs, wqkv, sqkv, bqkv),
             (xq, rs, wqkv, sqkv, bqkv), xq, wqkv),
        gemm("K9", f"O {L}x{DIM}x{DIM} + bias, gate, residual",
             lambda: qt._int8_gemm_postscale_cuda(xq, rs, wo, so, bk_, None, gate,
                                                  x2),
             lambda: qt.int8_gemm_postscale_plain(xq, rs, wo, so, bk_, gate=gate,
                                                  residual=x2),
             (xq, rs, wo, so, bk_, gate, x2), xq, wo),
        gemm("K9", f"cross K {TEXT}x{DIM}x{DIM} + bias",
             lambda: qt._int8_gemm_postscale_cuda(cq, crs, wk, sk, bk_, None, None,
                                                  None),
             lambda: qt.int8_gemm_postscale_plain(cq, crs, wk, sk, bk_),
             (cq, crs, wk, sk, bk_), cq, wk),
        gemm("K10", f"fc1 {L}x{FFN}x{DIM} + bias, GELU -> int8, BN {BNQ}",
             lambda: qt._int8_gemm_qout_cuda(xq, rs, w1, s1, b1, "gelu_tanh"),
             lambda: qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1,
                                                       act="gelu_tanh"),
             (xq, rs, w1, s1, b1), xq, w1, **scale_tol),
        gemm("K11", f"fc2 {L}x{DIM}x{FFN}, K slabs {BNQ}, + bias, gate, residual",
             lambda: qt._int8_gemm_blockact_cuda(hq, hs, w2, s2, b2, None, BNQ,
                                                 gate, x2),
             lambda: qt.int8_gemm_blockact_plain(hq, hs, w2, s2, b2, bk=BNQ,
                                                 gate=gate, residual=x2),
             (hq, hs, w2, s2, b2, gate, x2), hq, w2),
    ]


def _k12_checks(x, ms, mb, w, bias):
    """K12 as norm1 / norm2 (modulated) and norm3 (affine) on x's rows;
    `F.layer_norm` (bf16 out) beside it as a yardstick."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)
    n_x, D = x.numel(), x.shape[-1]
    return [
        Check("K12", f"mod -> int8 (norm1/norm2), D {D}",
              lambda: fn._mln_quant_cuda(x, ms, mb, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=True),
              (x, ms, mb), {"fp32": 11 * n_x}, **scale_tol,
              yardsticks={"F.layer_norm (bf16 out)":
                          lambda: torch.nn.functional.layer_norm(x, (D,), eps=1e-6)}),
        Check("K12", f"affine -> int8 (norm3), D {D}",
              lambda: fn._mln_quant_cuda(x, None, None, w, bias, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, None, None, w, bias, 1e-6,
                                                  quant_out=True),
              (x, w, bias), {"fp32": 11 * n_x}, **scale_tol),
    ]


def _int8_feed_checks(randn, x, ms, mb, w, bias, kt, vt, sdpa):
    """Phase-2 checks of K12-K14 at the 1.3B W8A8 path's shapes: K12 as
    norm1 / norm2 and norm3; K13 over K7-shaped planes (B, 12, 32,768, 128)
    to the 32,760 live rows; K14 as the cross attention of the trunk's raw Q
    rows over 512 text keys. No PyTorch call computes these functions:
    beside K12 `F.layer_norm` and beside K14 SDPA of the cross shape (the
    attention alone, bf16 out) are timed as yardsticks."""
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    DIM, HEADS = G13.dim, G13.heads
    planes = randn(B, HEADS, LP, DH, std=2.0)
    qn = fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH)
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)
    n_x = x.numel()
    # K12 at batch 2 with the modulation as the block passes it: column views
    # of one (B, 6, D) tensor, which the wrapper copies before the launch
    x2 = torch.cat([x, x.flip(1)])
    e2 = torch.stack([torch.stack([mb[0], ms[0]] * 3), torch.stack([ms[0], mb[0]] * 3)])
    return _k12_checks(x, ms, mb, w, bias) + [
        Check("K12", f"mod -> int8 at batch 2, strided (2, 6, {DIM}) modulation",
              lambda: fn.modulated_layer_norm(x2, e2[:, 1:2], e2[:, 0:1],
                                              eps=1e-6, quant_out=True),
              lambda: fn.modulated_layer_norm_ref(x2, e2[:, 1:2], e2[:, 0:1],
                                                  eps=1e-6, quant_out=True),
              (x2, e2[:, :2]), {"fp32": 22 * n_x}, **scale_tol),
        Check("K13", f"planes {HEADS}x{LP}x{DH} -> {L}x{DIM} int8",
              lambda: sf._unfold_quant_cuda(planes, L),
              lambda: sf.unfold_quant_plain(planes, L),
              (planes[:, :, :L],), {"fp32": 3 * n_x}, **scale_tol),
        Check("K14", f"q-norm + cross {L}x{TEXT} -> int8",
              lambda: fa._cross_qout_cuda(x, kt, vt, w, DH ** -0.5, 1e-6),
              lambda: fa.cross_attention_qout_plain(x, kt, vt, w, DH ** -0.5, 1e-6),
              (x, w, kt, vt), {"bf16": 4 * B * HEADS * L * TEXT * DH},
              atol=0.0, rtol=K14_SCALE_RTOL,
              yardsticks={"SDPA of the cross shape (attention only)":
                          sdpa(qn, kt, vt)}),
    ]


def _wide_checks(randn, sdpa):
    """Phase-2 checks of the 14B path's kernel forms (dim 5120, 40 heads,
    FFN 13824): K15 on a projection's rows; K5's three passes of the fused
    path at 40 heads, Q and K reading K15's RMS; K6 and K7 at 40 heads on
    those planes (12 of 128 K blocks); K16 over K7-shaped planes (B, 40,
    32,768, 128); K17 (q-norm with K15's RMS, cross attention over 512 text
    keys, int8 O feed); K12 and K8-K11 at the 14B widths. No PyTorch call
    computes K15-K17: SDPA of the cross shape is timed beside K17."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    DIM, HEADS = G14.dim, G14.heads
    x = randn(B, L, DIM)
    xk, xv = randn(B, L, DIM), randn(B, L, DIM)
    ms, mb = randn(B, DIM, dtype=torch.float32, std=0.1), \
        randn(B, DIM, dtype=torch.float32, std=0.1)
    w = (1 + randn(DIM, dtype=torch.float32, std=0.1)).bfloat16()
    bias = randn(DIM, std=0.1)
    kt, vt = randn(B, TEXT, HEADS, DH), randn(B, TEXT, HEADS, DH)
    cosF, sinF = fn.rope_cos_sin_full(rope_freqs_3d(21, 30, 52, DH, device=x.device))
    ri_q, ri_k = sf.row_rms_inv_plain(x, 1e-6), sf.row_rms_inv_plain(xk, 1e-6)
    hp = dict(num_heads=HEADS, eps=1e-6, pad_to=LP)
    q_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BQ, quant=True,
                  bf16_out=False)
    k_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BK)
    Qp = sf.head_planes_plain(x, **q_form, **hp, rms_inv=ri_q)
    Kp = sf.head_planes_plain(xk, **k_form, **hp, rms_inv=ri_k)
    Vp = sf.head_planes_plain(xv, **hp)
    lut8, sel, k_mean = sf.block_map_from_pooled(Qp["pooled"], Kp["pooled"],
                                                 L, BK, TOPK)
    vi, vcs = si8.quantize_v_per_channel(Vp["bf16"], L)
    kp, vtp, ksb = sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L)
    i8_args = (Qp["i8"], Qp["scale"], kp, vtp, ksb, vcs, lut8)
    pairs7 = _sparse_pairs(lut8, BQ, BK, L, L)
    planes = randn(B, HEADS, LP, DH, std=2.0)
    qn = fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH)
    scale = DH ** -0.5
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)
    n_x = x.numel()
    return [
        Check("K15", f"row RMS inverse {L}x{DIM}",
              lambda: sf._row_rms_inv_cuda(x, 1e-6, None, 0),
              lambda: sf.row_rms_inv_plain(x, 1e-6), (x,), {"fp32": 2 * n_x},
              **scale_tol),
        Check("K5", f"14B Q (K15's RMS, rope, int8, pool {BQ}), {HEADS} heads",
              lambda: sf._head_planes_cuda(x, w, cosF, sinF, HEADS, 1e-6, BQ,
                                           True, False, LP, ri_q),
              lambda: sf.head_planes_plain(x, **q_form, **hp, rms_inv=ri_q),
              (x, w, ri_q, cosF[:L], sinF[:L]), {"fp32": 12 * n_x}),
        Check("K5", f"14B K (K15's RMS, rope, bf16, pool {BK}), {HEADS} heads",
              lambda: sf._head_planes_cuda(xk, w, cosF, sinF, HEADS, 1e-6, BK,
                                           False, True, LP, ri_k),
              lambda: sf.head_planes_plain(xk, **k_form, **hp, rms_inv=ri_k),
              (xk, w, ri_k, cosF[:L], sinF[:L]), {"fp32": 10 * n_x}),
        Check("K5", f"14B V (bf16 fold), {HEADS} heads",
              lambda: sf._head_planes_cuda(xv, None, None, None, HEADS, 1e-6, 0,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xv, **hp), (xv,), {}),
        Check("K6", f"14B pack K/V {BK}-row blocks, {HEADS} heads",
              lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, False),
              lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L),
              (Kp["bf16"], k_mean, vi), {"fp32": 4 * n_x}),
        Check("K7", f"14B int8 sparse ({sel}/{LP // BK} blocks) {BQ}/{BK}, "
              f"{HEADS} heads",
              lambda: si8._sparse_i8_vt_cuda(*i8_args, scale, BQ, BK, L, None, None),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, block_q=BQ,
                                                       block_k=BK, kv_len=L),
              i8_args, {"int8": 2 * DH * pairs7, "bf16": 2 * DH * pairs7}),
        Check("K16", f"planes {HEADS}x{LP}x{DH} -> {L}x{DIM} int8",
              lambda: sf._unfold_quant_wide_cuda(planes, L),
              lambda: sf.unfold_quant_wide_plain(planes, L),
              (planes[:, :, :L],), {"fp32": 3 * n_x}, **scale_tol),
        Check("K17", f"q-norm (K15's RMS) + cross {L}x{TEXT} -> int8, {HEADS} heads",
              lambda: fa._cross_qout_wide_cuda(x, ri_q, kt, vt, w, scale),
              lambda: fa.cross_attention_qout_wide_plain(x, ri_q, kt, vt, w, scale),
              (x, w, ri_q, kt, vt), {"bf16": 4 * B * HEADS * L * TEXT * DH},
              atol=0.0, rtol=K14_SCALE_RTOL,
              yardsticks={"SDPA of the cross shape (attention only)":
                          sdpa(qn, kt, vt)}),
    ] + _k12_checks(x, ms, mb, w, bias) + _w8a8_checks(randn, x, G14)


def _mode_checks(randn, Qp, Kp, k_mean, xv, lut8, q, k, v):
    """Phase-2 checks of K18-K21 at the 1.3B 480p shapes, and their
    poisoned-tail checks (returned to run after the timed checks): K18 and
    K19 on the fused operands at v_quant="row" (V from K5's per-row int8
    pass), K20 at blocks 64/64 (int(0.1 * 512) = 51 K blocks a Q block) on
    smooth-k'd bf16 q / k / v, with K3 on the same LUT beside it; K21 over
    the planes (the row path's form) and over (B, L, H, D) (the sla path's).
    K19-K21 take SHARP_ATOL and planted faults that must fail: K19 and K20
    with the LUT's last entry dropped; K21 with proj_l's weight zeroed (the
    bias alone), with v read from k, and with q doubled (phi at half the
    temperature). No single PyTorch call computes these functions."""
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    HEADS = G13.heads
    scale = DH ** -0.5
    Vr = sf.head_planes_plain(xv, num_heads=HEADS, eps=1e-6, pad_to=LP,
                              quant=True)
    kvi, ks = sf.subquant_pack_kv_plain(Kp["bf16"], k_mean, Vr["i8"])
    planes_args = (Qp["i8"], Qp["scale"], kvi, ks, Vr["scale"], lut8)
    pairs19 = _sparse_pairs(lut8, BQ, BK, L, L)
    ks_, bk64 = k - k.mean(dim=1, keepdim=True), 64
    _, lut64, sel64 = get_block_map(q, ks_, TOPK, bk64, bk64)
    pairs20 = _sparse_pairs(lut64, bk64, bk64, L, L)
    # K21's inputs make the linear term the whole output and make it depend
    # on each operand: q and k of std 4 (phi close to one-hot over D), v a
    # fixed permutation of k's channels plus noise (kv / ksum holds
    # conditional means of order 10, not the ~0 of independent v), proj_l's
    # weight of std D^-0.5 and a small bias: |o| of order 1
    q21, k21 = randn(B, L, HEADS, DH, std=4.0), randn(B, L, HEADS, DH, std=4.0)
    perm = torch.randperm(DH, generator=torch.Generator().manual_seed(0))
    v21 = (k21.float()[..., perm.to(k21.device)]
           + randn(B, L, HEADS, DH, dtype=torch.float32)).bfloat16()
    w21 = randn(DH, DH, dtype=torch.float32, std=DH ** -0.5)
    pb = randn(DH, dtype=torch.float32, std=0.01)
    qp, kp, vp = (torch.zeros(B, HEADS, LP, DH, dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    for t, src in ((qp, q21), (kp, k21), (vp, v21)):
        t[:, :, :L] = src.transpose(1, 2)                 # K5's zero rows past L

    def k21_planes(k_=kp, v_=vp, q_=qp, w_=w21):
        out = torch.empty(q_.shape, dtype=torch.bfloat16, device=q_.device)
        return la._linear_projected_cuda(q_, k_, v_, w_, pb, L, out)

    def i8_planes(lut_):
        return si8._sparse_i8_planes_cuda(*planes_args[:-1], lut_, scale, BQ, BK, L)

    sharp = dict(atol=SHARP_ATOL, rtol=RTOL)

    lin_ops = {"fp32": 2 * B * HEADS * (L + LP) * DH * DH}
    checks = [
        Check("K18", f"pack K|V per row {HEADS}x{LP}x{DH}",
              lambda: sf._subquant_pack_kv_cuda(Kp["bf16"], k_mean, Vr["i8"]),
              lambda: sf.subquant_pack_kv_plain(Kp["bf16"], k_mean, Vr["i8"]),
              (Kp["bf16"], k_mean, Vr["i8"]), {"fp32": 4 * Kp["bf16"].numel()},
              atol=0.0, rtol=SCALE_RTOL),
        Check("K19", f"int8 sparse per-row scales ({lut8.shape[-1]}/{LP // BK} "
              f"blocks) {BQ}/{BK}",
              lambda: i8_planes(lut8),
              lambda: si8.sparse_attention_i8_planes_plain(
                  *planes_args, block_q=BQ, block_k=BK, kv_len=L),
              planes_args, {"int8": 2 * DH * pairs19, "bf16": 2 * DH * pairs19},
              **sharp, faults={"last LUT entry dropped": lambda: i8_planes(lut8[..., :-1])}),
        Check("K20", f"int8-QK sparse gather ({sel64}/{LP // bk64} blocks) "
              f"{bk64}/{bk64}",
              lambda: fa._sparse_flash_i8qk_cuda(q, ks_, v, lut64, bk64, bk64,
                                                 scale, L),
              lambda: fa.sparse_flash_attention_i8qk_plain(q, ks_, v, lut64, bk64,
                                                           bk64, scale, L),
              (q, ks_, v, lut64), {"int8": 2 * DH * pairs20,
                                   "bf16": 2 * DH * pairs20},
              yardsticks={"K3 (bf16 QK) on the same LUT": lambda:
                          fa._sparse_flash_cuda(q, ks_, v, lut64, bk64, bk64,
                                                scale, L)},
              **sharp, faults={"last LUT entry dropped": lambda:
                               fa._sparse_flash_i8qk_cuda(q, ks_, v, lut64[..., :-1],
                                                          bk64, bk64, scale, L)}),
        Check("K21", f"linear branch over planes {HEADS}x{LP}x{DH}",
              k21_planes,
              lambda: la.linear_projected_planes_plain(qp, kp, vp, w21, pb, L),
              (qp, kp[:, :, :L], vp[:, :, :L], w21, pb), lin_ops, **sharp,
              faults={"proj_l weight zeroed (bias alone)":
                      lambda: k21_planes(w_=torch.zeros_like(w21)),
                      "v read from k": lambda: k21_planes(v_=kp),
                      "q doubled": lambda: k21_planes(q_=qp * 2)}),
        Check("K21", f"linear branch over (B, L, H, D) {L}x{HEADS}x{DH}",
              lambda: la.linear_attention_projected(q21, k21, v21, w21, pb),
              lambda: la.linear_attention_projected_plain(q21, k21, v21, w21, pb),
              (q21, k21, v21, w21, pb), {"fp32": 4 * B * HEADS * L * DH * DH},
              **sharp, faults={"proj_l weight zeroed (bias alone)": lambda:
                               la.linear_attention_projected(
                                   q21, k21, v21, torch.zeros_like(w21), pb)}),
    ]

    def k19_tail():
        """K19 on the card: K|V rows past kv_len set to +127 and their K / V
        scales to NaN change no live output row (flash_pallas.py:1406-1408
        zeroes them on the TPU; the port masks by column)."""
        clean = si8._sparse_i8_planes_cuda(*planes_args, scale, BQ, BK, L)
        pk, pks, pvs = kvi.clone(), ks.clone(), Vr["scale"].clone()
        pk[:, :, L:] = 127
        pks[:, :, L:] = float("nan")
        pvs[:, :, L:] = float("nan")
        poisoned = si8._sparse_i8_planes_cuda(Qp["i8"], Qp["scale"], pk, pks,
                                              pvs, lut8, scale, BQ, BK, L)
        torch.cuda.synchronize()
        if not torch.equal(clean[:, :, :L], poisoned[:, :, :L]):
            raise AssertionError("K19: a poisoned tail changed live rows")
        print(f"phase2 K19 poisoned tail (rows {L}..{LP - 1}: K|V = 127, "
              f"scales NaN): live rows unchanged", flush=True)

    def k21_tail():
        """K21 on the card: K and V plane rows past true_len set to NaN
        change no live output row (the TPU kernel's where() on k and v)."""
        clean = k21_planes()
        pk, pv = kp.clone(), vp.clone()
        pk[:, :, L:] = float("nan")
        pv[:, :, L:] = float("nan")
        poisoned = k21_planes(pk, pv)
        torch.cuda.synchronize()
        if not torch.equal(clean[:, :, :L], poisoned[:, :, :L]):
            raise AssertionError("K21: a poisoned tail changed live rows")
        print(f"phase2 K21 poisoned tail (K / V rows {L}..{LP - 1} = NaN): "
              f"live rows unchanged", flush=True)

    return checks, (k19_tail, k21_tail)


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
    """A WanAttentionBlock of cfg's widths with seeded random non-zero
    weights; proj_l is N(0, proj_l_std^2) (zero, as load_dit finds random
    weights, at 0)."""
    import torch
    from turbodiffusion_tpu_torch.models.wan import WanAttentionBlock
    blk = WanAttentionBlock(cfg, device=dev)
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


def _qk_proj(sa, h, dim: int):
    """The self-attention q and k projections of h (bf16, or K12's int8
    pair), through the fused qkv linear where the block has one."""
    from turbodiffusion_tpu_torch.models.wan import _lin_q
    if sa.qkv is not None:
        return _lin_q(sa.qkv, h).split(dim, -1)[:2]
    return _lin_q(sa.q, h), _lin_q(sa.k, h)


def phase3(attention: str, quant_linear: bool = False, device: str = "cuda",
           geo: Geometry = G13, v_quant: str = "channel", sla_block: int = 256,
           proj_l=None, batch: int = 1):
    """One full-width block of `geo`, card against CPU; returns the launch
    counts of its card run (set to 0 just before it, read just after).
    proj_l (default: on for sagesla at 256, off otherwise) makes it
    non-zero, so the linear branch runs: K6's kv sums and K7's epilogue on
    the channel path, K21 on the row and `sla` paths. quant_linear: the
    block's linears quantised as load_dit quantises them (W8A8 postscale,
    QKV fused below dim 4096), so the int8 feeds (K12-K14; K15-K17 at 14B)
    and the GEMMs K8-K11 run on the card and their plain versions on the
    CPU. v_quant and sla_block as `make_wan_cfg` takes them; batch > 1
    stacks independent random latents and contexts, and the card runs the
    block twice, bit-equal."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import (
        fused_sla_geometry, get_block_map)
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rope_cos_sin_full, rmsnorm_rope)
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.ops.sla_fused import (
        block_map_from_pooled, head_planes, row_rms_inv)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg(geo.model, attention, TOPK, quant_linear,
                       sla_block=sla_block, v_quant=v_quant)
    DIM, HEADS = geo.dim, geo.heads
    fused = fused_sla_geometry(cfg.attention, DH)
    lin = fused and v_quant == "channel" if proj_l is None else proj_l
    if not lin:
        cfg = cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                        linear_branch=False))
    a = cfg.attention
    dev = torch.device(device)
    blk = _random_block(cfg, dev, seed=1, proj_l_std=0.05 if lin else 0.0).eval()
    if quant_linear:
        quantize_wan_blocks([blk], mode="postscale", fuse_qkv=geo.fuse_qkv)
    blk_cpu = copy.deepcopy(blk).cpu()
    g = torch.Generator(device=dev).manual_seed(2)
    T, Hs, Ws = 1, 30, 52
    n = T * Hs * Ws
    x = torch.randn((batch, n, DIM), generator=g, device=dev).bfloat16()
    e0 = 0.1 * torch.randn((batch, 6, DIM), generator=g, device=dev)
    ctx = torch.randn((batch, TEXT, DIM), generator=g, device=dev).bfloat16()
    rope = rope_cos_sin_full(rope_freqs_3d(T, Hs, Ws, DH, device=dev))

    def block_map(b, x, e0, rope):
        e = b.modulation.float()[None] + e0
        h = modulated_layer_norm(x, e[:, 1:2], e[:, 0:1], eps=cfg.eps,
                                 quant_out=quant_linear)
        sa = b.self_attn
        q_proj, k_proj = _qk_proj(sa, h, DIM)
        if fused:
            # as sla_attention_fused: K15's RMS for rows wider than 4096
            ri = ((lambda p: row_rms_inv(p, cfg.eps)) if DIM > 4096
                  else (lambda p: None))
            kw = dict(num_heads=HEADS, eps=cfg.eps, pad_to=-(-n // 512) * 512)
            pq = head_planes(q_proj, sa.norm_q, *rope, pool=a.block_q,
                             quant=True, bf16_out=False, rms_inv=ri(q_proj),
                             **kw)["pooled"]
            pk = head_planes(k_proj, sa.norm_k, *rope, pool=a.block_k,
                             rms_inv=ri(k_proj), **kw)["pooled"]
            return block_map_from_pooled(pq, pk, n, a.block_k, a.sla_topk)[0]
        q = rmsnorm_rope(q_proj, sa.norm_q, *rope, num_heads=HEADS, eps=cfg.eps)
        k = rmsnorm_rope(k_proj, sa.norm_k, *rope, num_heads=HEADS, eps=cfg.eps)
        return get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]

    launchers = _launchers()
    cpu_args = (x.cpu(), e0.cpu(), tuple(t.cpu() for t in rope))
    with torch.no_grad():
        lut_gpu = block_map(blk, x, e0, rope).cpu()
        lut_cpu = block_map(blk_cpu, *cpu_args)
        same = (lut_gpu.sort(-1).values == lut_cpu.sort(-1).values).all(-1)
        bad_q = sorted(set((~same).nonzero()[:, 2].tolist()))
        for fn in launchers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = blk(x, e0, rope, ctx)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms_gpu = (time.perf_counter() - t0) * 1e3
        counts = {name: fn.launches for name, fn in launchers.items()
                  if fn.launches}
        if batch > 1 and not torch.equal(out, blk(x, e0, rope, ctx)):
            # the kernels are deterministic, so a second run matches bit for
            # bit unless a kernel reads memory that is being reused
            raise AssertionError(f"phase3 batch {batch}: two card runs differ")
        t0 = time.perf_counter()
        ref = blk_cpu(*cpu_args, ctx.cpu())
        ms_cpu = (time.perf_counter() - t0) * 1e3
    keep = torch.ones(n, dtype=torch.bool)
    for i in bad_q:
        keep[i * a.block_q:(i + 1) * a.block_q] = False
    if not keep.any():
        raise AssertionError(f"phase3 {attention}: every Q-block's LUT differs")
    label = (attention + (" + W8A8" if quant_linear else "")
             + (f" v_quant {v_quant}" if v_quant != "channel" else "")
             + (f" blocks {a.block_q}/{a.block_k}" if sla_block != 256 else "")
             + (f" batch {batch}" if batch > 1 else ""))
    max_err, mean_err, _, want_mean, _ = _compare(
        f"phase3 {label} block", out.cpu()[:, keep], ref[:, keep], BLOCK_ATOL,
        BLOCK_RTOL)
    print(f"phase3 {geo.model} {label} block L={n}"
          f"{' (proj_l != 0, linear branch on)' if lin else ''}: LUT rows "
          f"equal as sets {int(same.sum())}/{same.numel()} (Q-blocks left out "
          f"of the comparison: {bad_q}) | max_abs_err {max_err:.5g} "
          f"mean_abs_err {mean_err:.5g} (tol atol {BLOCK_ATOL} + rtol "
          f"{BLOCK_RTOL}; |want| mean {want_mean:.5g}) | card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | "
          f"{'two card runs bit-equal | ' if batch > 1 else ''}launches {counts}",
          flush=True)
    return counts


def phase4(label: str, geo: Geometry, attention: str, quant_linear: bool,
           requests: int, create_kw: dict):
    """`requests` 480p/81f requests through WanPipeline.create(geo.model,
    attention_type=attention, quant_linear=quant_linear, **create_kw), then
    a traced denoise (`_profile_denoise`); frees the pipeline and returns
    the launch counts of the last request."""
    import torch
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    launchers = _launchers()
    want = {n: EXPECTED_LAUNCHES[label].get(n, 0) for n in launchers}
    t0 = time.perf_counter()
    pipe = WanPipeline.create(model=geo.model, attention_type=attention,
                              sla_topk=TOPK, quant_linear=quant_linear, seed=0,
                              device="cuda", **create_kw)
    torch.cuda.synchronize()
    print(f"phase4 {label} create: {time.perf_counter() - t0:.1f} s, "
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
            raise AssertionError(f"{label} launch counts {counts} != {want}")
        if tuple(video.shape) != (1, 3, 81, 480, 832):
            raise AssertionError(f"video shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        lo, hi = float(video.min()), float(video.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"video outside [0, 1]: [{lo}, {hi}]")
        print(f"phase4 {label} request {r}: text-encode "
              f"{timings['text_encode_ms']:.1f} ms | denoise "
              f"{timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | video "
              f"{tuple(video.shape)} in [{lo:.3f}, {hi:.3f}] | launches "
              f"{counts}", flush=True)
    _profile_denoise(pipe, label)
    del pipe, video
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# kernel-name substrings -> category, first match wins
PROFILE_CATEGORIES = [
    ("K1", ("mln_kernel<false",)), ("K12", ("mln_kernel<true",)),
    ("K2", ("rmsrope_kernel",)), ("K13", ("unfold_quant_kernel",)),
    ("K14", ("cross_qout_kernel<false>",)), ("K15", ("row_rms_inv_kernel",)),
    ("K16", ("unfold_quant_wide_kernel",)), ("K17", ("cross_qout_kernel<true>",)),
    ("K3", ("flash_fwd_kernel<true>",)), ("K4", ("flash_fwd_kernel<false>",)),
    ("K5", ("head_planes_kernel",)), ("K6", ("subquant_pack_kvt_kernel",)),
    ("K6/K21 linear kv", ("linear_kv_",)), ("K7", ("sparse_i8_vt_kernel",)),
    ("K18", ("subquant_pack_kv_kernel",)), ("K19", ("sparse_i8_planes_kernel",)),
    ("K20", ("sparse_flash_i8qk_kernel",)), ("K21 apply", ("linear_apply_kernel",)),
    # K8-K11 before the library GEMMs: K9-K11's name holds "gemm"
    ("K8", ("quantize_rows_kernel",)), ("K9", ("int8_gemm_kernel<0>",)),
    ("K10", ("int8_gemm_kernel<1>",)), ("K11", ("int8_gemm_kernel<2>",)),
    ("GEMM", ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")),
    ("top-k/sort", ("topk", "sort", "radix")), ("reduce", ("reduce",)),
]


def _profile_denoise(pipe, label: str):
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
    line = (f"phase4 {label} profile, denoise 4 DiT calls: "
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
    block_counts = {}
    if 3 in phases:
        for attention, quant_linear in (("sla", False), ("sagesla", False),
                                        ("sagesla", True), ("sla", True)):
            phase3(attention, quant_linear)
        # the other sagesla configurations and the linear branch, each block
        # with the kernels it must launch
        for label, kw, must in (
                ("row", dict(attention="sagesla", quant_linear=True,
                             v_quant="row", proj_l=True), ("K18", "K19", "K21")),
                ("block64", dict(attention="sagesla", quant_linear=True,
                                 sla_block=64), ("K2", "K20")),
                ("sla+proj_l", dict(attention="sla", proj_l=True), ("K3", "K21")),
                ("batch2", dict(attention="sagesla", quant_linear=True, batch=2),
                 ("K5", "K6", "K7", "K12", "K13"))):
            block_counts[label] = phase3(**kw)
            missing = [n for n in must if not block_counts[label].get(n)]
            if missing:
                raise AssertionError(f"phase3 {label}: {missing} never launched")
        phase3("sagesla", True, geo=G14)
    counts = {}
    if 4 in phases:
        # a kernel's launches come from the 14B path (run last) where it
        # runs there, else from the first earlier path that runs it; K21,
        # which no request runs (random weights: proj_l = 0), from the
        # phase-3 block of the row path
        by_path = [phase4(*path) for path in PATHS]
        for path_counts in by_path[-1:] + by_path[:-1]:
            for name, c in path_counts.items():
                counts[name] = counts.get(name) or c
        counts["K21"] = block_counts.get("row", {}).get("K21", 0)
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
