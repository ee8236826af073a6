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
     over (B, L, H, D); K22 at the block-scale checkpoint path's GEMM
     shapes in bf16 and at 1536 x 1536 and a ragged shape in fp32,
     bit-equal; then the Wan2.1-14B forms: K15, K5 with K15's RMS at 40
     heads, K6, K7, K16, K17, K12 and K8-K11 at dim 5120, FFN 13824), with
     poisoned-tail checks of K7, K19 and K21: max absolute error under the
     stated tolerance (int8 outputs within 1 LSB; K19-K21 at atol 4e-3 +
     rtol 2e-2, each with planted faults the check must reject: a dropped
     LUT entry, K21's weight zeroed, v read from k, q doubled; K22 exact in
     fp32, one bf16 step in bf16, rejecting its block scales transposed or
     shifted by one M block), the mean and max |output| beside it, both
     times
     (CUDA events, median of a few runs), the least time the card could
     take (`bound`: bytes over 3.35 TB/s or operations over the dense peak
     of their type, whichever is larger) and, where one PyTorch call
     computes the same function, that call's time (`library`; for the int8
     GEMMs `torch._int_mm`, the product alone, plus bf16 `torch.matmul` of
     the same shape); the port calls neither. Then K23 / K24, the
     block-sparse backward, at the 1.3B training shape (q of std 3, a
     K-block no Q-block selects, NaN in the buffers' rows past L; planted
     faults: an inverse-LUT entry dropped, delta left out of dS, dk without
     `scale`; (lse, delta) in fp32, K24 ignoring their rows past L, dk = dv
     = 0 on the unselected block, two runs bit-equal; no library call: the
     dense SDPA backward of the shape beside them for scale); then K25 / K26,
     forward-mode attention (o and its tangent do), at the training shape:
     K25 self 32,760 x 32,760 and cross 32,760 x 512, K26 at 512/256 with
     12 of 128 K-blocks (q of std 3, tangents the size of the primals, NaN
     in the rows past each length; atol 0.1 + rtol 2e-2; planted faults: mu left out of do, P dv
     left out, q dk^T left out of dS, K26's last LUT entry dropped; two runs
     bit-equal; no library call: the SDPA forward of the shape beside them);
  3. one full-width `WanAttentionBlock` with seeded random non-zero weights
     at one 480p latent frame (1,560 tokens): at 1.3B `sla`, `sagesla`,
     `sagesla` with W8A8 linears and `sla` with W8A8 linears (the sagesla
     blocks with a non-zero `proj_l`, so the fused linear epilogue runs; the
     W8A8 blocks take the int8 feeds K12-K14), W8A8 `sagesla` at
     v_quant="row" with a non-zero `proj_l` (K18, K19, K21 over the planes),
     W8A8 `sagesla` at blocks 64/64 (K20), bf16 `sla` with a non-zero
     `proj_l` (K21 over (B, L, H, D)), W8A8 `sagesla` at batch 2 and
     `sagesla` with 128x128 block-scaled linears and a non-zero `proj_l`
     (the bf16 composition, K22 for each linear), and at 14B `sagesla`
     with W8A8 linears (unfused Q / K / V, K15-K17): the
     kernels on the card against the plain versions on the CPU, on the Q
     blocks whose block-map rows agree as sets, with each block's launch
     counts; then one 1.3B `sla` block (proj_l != 0) forward and backward,
     card (K23 + K24) against CPU: the output and the gradients of its 29
     parameters and 3 inputs, each within 5% relative L2 (K21's earlier
     JSON source: random weights give the requests a
     zero `proj_l`); then one 1.3B `original` and one `sla` block (proj_l !=
     0) in the sCM tangent pass (forward AD, `jvp_mode`), card (K25, K26)
     against CPU: o and do each within 5% relative L2, launches exactly K25
     2 (dense) or K26 1 + K25 1 (sla);
  4. the paths: `WanPipeline.create(..., attention_type="sagesla",
     quant_linear=True)` with random weights and two 480p/81f 4-step
     `generate_t2v` requests, then one request each of bf16 `sagesla` and
     `sla`, one W8A8 `sagesla` request at v_quant="row" and one at
     sla_block=64, then two requests of `WanPipeline.create(dit_path=...)`
     on a 1.3B sagesla checkpoint that the port's writer saves first (block-
     scaled linears, non-zero `proj_l` and head; the loaded DiT must equal
     the written one tensor for tensor), then, with the 1.3B pipelines
     freed, two requests of
     `WanPipeline.create("Wan2.1-14B", quant_linear=True)`; per request the
     text-encode, denoise and VAE-decode times, peak device memory, and the
     launch count of every kernel, set to 0 just before the request and
     read just after (1.3B W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 6, K10
     1, K11 1, K12 3, K13 1, K14 1 per block; bf16 sagesla: K1 3, K2 1, K4
     1, K5 3, K6 1, K7 1; sla: K1 3, K2 3, K3 1, K4 1; W8A8 row: K5 3, K8 2,
     K9 6, K10 1, K11 1, K12 3, K13 1, K14 1, K18 1, K19 1; W8A8 block 64:
     K2 2, K8 3, K9 6, K10 1, K11 1, K12 3, K14 1, K20 1; checkpoint: K1
     3, K2 1, K4 1, K5 3, K6 1, K7 1, K22 10; x 30 blocks x 4 steps; 14B
     W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 8, K10 1, K11 1,
     K12 3, K15 3, K16 1, K17 1 x 40 blocks x 4 steps; every other kernel
     0), which shows each path went through its kernels; then each path's
     denoise under torch.profiler: device time by kernel category and the
     device's idle share;
  5. SLA fine-tuning through the training CLI (`scripts.train.main
     --experiment sla`) from a 1.3B teacher checkpoint the port's writer
     saves first (non-zero head and proj_l) and tar shards written here:
     3 steps at 480p/81f, full width and depth, --remat block_wise (per
     step: wall time and its teacher / forward / backward / optimizer
     split, loss, peak memory, exact launches K1 270, K2 270, K3 60, K4
     120, K21 60, K23 30, K24 30; non-zero q / k / v / proj_l gradients;
     step 2 under torch.profiler), 1 step at 480p/21f, --remat none (K1
     180, K2 180, K3 30, K4 90, K21 30, K23 30, K24 30), and the
     checkpoint save -> resume round trip at 2 layers;
  6. rCM distillation through the training CLI (`scripts.train.main
     --experiment rcm`) from phase 5's teacher checkpoint and 81f shards,
     full width and depth, --remat block_wise: the dense student's
     iteration 0 (sCM + DMD + EMA; launches K1 630, K2 630, K4 420, K25 60)
     and iteration 1 (the critic's; K1 270, K2 270, K4 180), then one student
     iteration with `-- model.attention.backend=sla` (K1 630, K2 630, K3
     210, K4 210, K21 210, K23 60, K24 60, K26 30, K25 30; profiled); per
     iteration the wall time and its split, the losses (finite), peak
     memory, exact launches, and the watched weights of what it trains
     moved (student and EMA, or fake score) and of nothing else (the
     teacher never); then the DistillState save -> resume round trip at 2
     layers.
Then one JSON line with every kernel's numbers (a kernel the 14B path runs:
its 14B checks and that path's launches; K21, K23, K24: their 1.3B checks
and one training step's launches; K25, K26: one student iteration's of
phase 6 (dense, sla); any other: its 1.3B checks and the
launches of the first 1.3B path that runs it), the
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
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# K25 / K26's do = acc_t / l - mu o subtracts terms of up to ~25 (q of std
# 3) whose bf16-rounded P dS the kernel rounds at the running max of the
# online softmax and the plain version at the row's final max, as the TPU
# kernel and its jnp reference do: ~2^-8 x 25 = 0.1 absolute; the planted
# faults miss by 4 and more
JVP_ATOL = 0.1
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
    # a reference-layout checkpoint with 128x128 block-scaled linears: the
    # bf16 sagesla composition (K1 x 3, K2 on the cross q, K4) with each of
    # the ten linears a K22, and the linear branch on (a non-zero proj_l:
    # K6's linear kv, K7's linear epilogue)
    "1.3b checkpoint": {**_SAGESLA, "K1": 360, "K2": 120, "K4": 120,
                        "K22": 1200},
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
         # dit_path: a checkpoint the port's writer saves first
         ("1.3b checkpoint", G13, "sagesla", False, 2, {"dit_path": None}),
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
    "K22": ("turbodiffusion_tpu_torch/csrc/quant.cu",
            "turbodiffusion_tpu/ops/quant.py:890"),
    "K23": ("turbodiffusion_tpu_torch/csrc/sparse_attention_bwd.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1796"),
    "K24": ("turbodiffusion_tpu_torch/csrc/sparse_attention_bwd.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1836"),
    "K25": ("turbodiffusion_tpu_torch/csrc/flash_jvp.cu",
            "turbodiffusion_tpu/ops/flash_jvp_pallas.py:170"),
    "K26": ("turbodiffusion_tpu_torch/csrc/flash_jvp.cu",
            "turbodiffusion_tpu/ops/flash_jvp_pallas.py:367"),
}


def _launchers():
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    from turbodiffusion_tpu_torch.ops import quant as qt
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
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
            "K21": la._linear_projected_cuda, "K22": qt._int8_block_matmul_cuda,
            "K23": sb._sparse_bwd_dq_cuda, "K24": sb._sparse_bwd_dkv_cuda,
            "K25": fj._flash_jvp_cuda, "K26": fj._sparse_flash_jvp_cuda}


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
    bwd_checks, bwd_extra = _bwd_checks(randn)
    jvp_checks, jvp_extra = _jvp_checks(randn, sdpa)
    results = _run_checks(checks + mode_checks + _block_gemm_checks(randn)
                          + bwd_checks + jvp_checks, reps)
    _poisoned_tail(i8_args, scale)
    for tail in (*tails, bwd_extra, jvp_extra):
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


def _block_gemm_checks(randn):
    """Phase-2 checks of K22 at the 1.3B block-scale checkpoint path's
    shapes (bf16 out, as the path writes it: self q / k / v / o and cross
    q / o 32760x1536x1536, fc1 32760x8960x1536, fc2 32760x1536x8960, text
    k / v 512x1536x1536) and in fp32 on the square shape and a ragged one
    (1000x300x200: K and N padded), fp32 bit-equal to the plain version
    (the same fp32 terms in the same K-block order), bf16 within one step.
    The block scales span a factor of ~55, so a scale read from the wrong
    block shows; two planted faults must be rejected: ws transposed (on the
    square shape, where the shapes cannot catch it) and xs shifted by one
    M block. Beside each: `torch._int_mm` (the product alone) and bf16
    `torch.matmul` of the same shape; beside the 1536- and 8960-wide ones,
    the plain-torch activation quantiser that feeds K22 on the path."""
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt

    def scales(r, c):
        return 1e-3 * torch.exp(4 * randn(r, c, dtype=torch.float32).sigmoid())

    def int8(*shape):
        return randn(*shape, dtype=torch.float32, std=60.0).round().clamp(
            -127, 127).to(torch.int8)

    def check(what, M, K, N, out, faults=False, quantiser=False):
        cd = lambda n: -(-n // 128)                     # noqa: E731
        xq, wq = int8(M, K), int8(N, K)
        x = randn(M, K)
        xs, ws = scales(cd(M), cd(K)), scales(cd(N), cd(K))
        b = randn(N, dtype=torch.float32, std=0.5)
        exact = out == torch.float32
        tol = dict(atol=0.0, rtol=0.0 if exact else 2.0 ** -8)
        fault = {"ws transposed": lambda: qt._int8_block_matmul_cuda(
                     xq, xs, wq, ws.t().contiguous(), b, out),
                 "xs shifted by one M block": lambda: qt._int8_block_matmul_cuda(
                     xq, xs.roll(1, 0), wq, ws, b, out)} if faults else {}
        lib = (lambda: torch._int_mm(xq, wq.t())) if M > 16 and K % 8 == 0 \
            and N % 8 == 0 else None
        wb = randn(N, K)
        yard = {"bf16 torch.matmul": lambda: torch.matmul(x, wb.t())}
        if quantiser:       # the linear's input quantiser (plain torch)
            yard[f"quantize_activation_block {M}x{K} (plain torch)"] = \
                lambda: qt.quantize_activation_block(x)
        return Check("K22", f"{what} {M}x{N}x{K} + bias, {str(out)[6:]} out",
                     lambda: qt._int8_block_matmul_cuda(xq, xs, wq, ws, b, out),
                     lambda: qt.int8_block_matmul_plain(xq, xs, wq, ws, b, out),
                     (xq, xs, wq, ws, b), {"int8": 2 * M * N * K}, lib,
                     "torch._int_mm (product only)", yard, faults=fault, **tol)

    D, F = G13.dim, G13.ffn
    bf, f32 = torch.bfloat16, torch.float32
    return [check("self / cross q, k, v, o", L, D, D, bf, quantiser=True),
            check("fc1", L, D, F, bf), check("fc2", L, F, D, bf, quantiser=True),
            check("text k / v", TEXT, D, D, bf),
            check("square", L, D, D, f32, faults=True),
            check("ragged", 1000, 200, 300, f32)]


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


# the K-block phase 2's K23 / K24 LUT never selects
ZERO_BLOCK = 5


def _without_block(lut, j: int):
    """lut with K-block j replaced, in each row that names it, by the
    smallest block id the row does not name: no Q-block selects j."""
    import numpy as np
    import torch
    a = lut.cpu().numpy().copy()
    nK = -(-L // BK)
    for row in a.reshape(-1, a.shape[-1]):
        if j in row:
            row[row == j] = next(c for c in range(nK) if c != j and c not in row)
    return torch.from_numpy(a).to(lut.device)


def _bwd_checks(randn):
    """K23 and K24 at the 1.3B training shape (32,760 tokens, 12 heads,
    blocks 512/256, topk 0.1) against their plain versions on the card.
    Inputs where every term matters: q of std 3, so each row's softmax
    leans on a few keys and its output o on a few rows of v; dO of N(0, 1),
    so delta (= dO . o) is of the order of dp and leaving it out of dS
    shows. (dO = 4 o + N(0, 1) makes |dq| ~30, where dq = scale (acc1 -
    delta acc2) / l, a difference of sums of bf16-rounded terms, is only
    good to ~0.1-0.4 absolute, and beyond atol 2e-2 + rtol 2e-2.) q, k, v, dO are views of
    buffers whose rows past L hold NaN; K-block ZERO_BLOCK is never
    selected. Planted faults K24's check must reject: one inverse-LUT entry
    dropped, delta left out of dS, dk without `scale`. Returns (checks, a
    function of the further checks: lse / delta in fp32, K24 ignoring (lse,
    delta) rows past L, dk = dv = 0 on the unselected block, two runs of
    each kernel bit-equal)."""
    import torch
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    HEADS = G13.heads

    def view(t):                     # rows past L of the buffer: NaN
        t[:, L:] = float("nan")
        return t[:, :L]

    q, k, v = (view(randn(B, LP, HEADS, DH, std=sd)) for sd in (3.0, 1.0, 1.0))
    lut = _without_block(get_block_map(q, k, TOPK, BQ, BK)[1], ZERO_BLOCK)
    scale = DH ** -0.5
    do = view(randn(B, LP, HEADS, DH))
    nK = -(-L // BK)
    inv = sb.inverse_lut(lut, nK)
    pairs = _sparse_pairs(lut, BQ, BK, L, L)

    def k23(lut_=lut):
        dq, ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut_, BQ, BK, scale, L)
        return dq, ld[:, :L]

    def k23_plain():
        dq, ld = sb.sparse_bwd_dq_plain(q, k, v, do, lut, BQ, BK, scale, L)
        return dq, ld[:, :L]

    ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, BQ, BK, scale, L)[1]

    def k24(inv_=inv, ld_=ld):
        return sb._sparse_bwd_dkv_cuda(q, k, v, do, ld_, inv_, BQ, BK, scale, L)

    dropped = inv.clone()
    bh, kb = divmod(int(inv[:, :, 0].argmax()), nK)
    dropped[bh, kb, 0] -= 1          # the row's last Q-block left out
    no_delta = ld.clone()
    no_delta[..., 1] = 0

    def unscaled():
        dk, dv = k24()
        return dk.float() / scale, dv

    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    o_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    sdpa_bwd = {"dense SDPA backward (dq, dk, dv), for scale":
                lambda: torch.autograd.grad(o_s, (qs, ks, vs), do.transpose(1, 2),
                                            retain_graph=True)}
    sel = lut.shape[-1]
    checks = [
        Check("K23", f"dq pass + (lse, delta), {sel}/{nK} blocks {BQ}/{BK}, "
              f"rows {L}..{LP - 1} NaN", k23, k23_plain, (q, k, v, do, lut),
              {"bf16": 3 * 2 * DH * pairs}, yardsticks=sdpa_bwd),
        Check("K24", f"inverse-LUT dk/dv pass, block {ZERO_BLOCK} never selected",
              k24, lambda: sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, BQ, BK,
                                                   scale, L),
              (q, k, v, do, ld, inv), {"bf16": 4 * 2 * DH * pairs},
              faults={"one inverse-LUT entry dropped": lambda: k24(inv_=dropped),
                      "delta left out of dS": lambda: k24(ld_=no_delta),
                      "dk without scale": unscaled}),
    ]

    def extra():
        dq, ld_k = k23()
        dq_p, ld_p = k23_plain()
        torch.cuda.synchronize()
        ld_err = float((ld_k - ld_p).abs().max())
        if not torch.allclose(ld_k, ld_p, atol=1e-3, rtol=1e-4):
            raise AssertionError(f"K23 (lse, delta) off by {ld_err}")
        poisoned = ld.clone()
        poisoned[:, L:] = float("nan")
        dk, dv = k24()
        dk_p, dv_p = k24(ld_=poisoned)
        blk = slice(ZERO_BLOCK * BK, (ZERO_BLOCK + 1) * BK)
        if not (torch.equal(dk, dk_p) and torch.equal(dv, dv_p)):
            raise AssertionError("K24 read (lse, delta) rows past L")
        if dk[:, blk].any() or dv[:, blk].any():
            raise AssertionError(f"K24: block {ZERO_BLOCK} has non-zero dk / dv")
        dk2, dv2 = k24()
        if not (torch.equal(dq, k23()[0]) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError("K23 / K24: two runs differ")
        print(f"phase2 K23/K24 tail and stability: (lse, delta) max_abs_err "
              f"{ld_err:.3g} (tol atol 1e-3 + rtol 1e-4, fp32) | K24 with "
              f"(lse, delta) rows {L}..{LP - 1} NaN: bit-equal | block "
              f"{ZERO_BLOCK} (never selected): dk = dv = 0 exactly | two runs "
              f"of each: bit-equal", flush=True)
    return checks, extra


def _epilogue_without_mu(s, ds, v, dv):
    """`ops/flash_jvp._jvp_epilogue` with mu (rowsum P dS) left out of do:
    a planted fault of K25 / K26, made by their plain versions."""
    import torch
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    pb = p.to(v.dtype).float()
    acc_t = (torch.matmul((p * ds).to(v.dtype).float(), v.float())
             + torch.matmul(pb, dv.float()))
    return torch.matmul(pb, v.float()) / l, acc_t / l


def _jvp_checks(randn, sdpa):
    """K25 (self 32,760 x 32,760 and cross 32,760 x 512) and K26 (blocks
    512/256, topk 0.1: 12 of 128 K-blocks) at the 1.3B training shape, 12
    heads, against their plain versions on the card. q of std 3, so each
    row's softmax leans on a few keys, and tangents of N(0, 1), the size of
    the primals: mu, P dv and both terms of dS all matter (with flat
    attention a kernel without mu would pass). q, k, v and the tangents are
    views of buffers whose rows past their length hold NaN. Tolerance atol
    JVP_ATOL + rtol 2e-2. Planted faults each check must reject: mu left out of do (the plain version so
    changed), P dv left out (the kernel with dv = 0), q dk^T left out of dS
    (the kernel with dk = 0) and, for K26, the last LUT entry of every row
    dropped. No PyTorch call computes an attention JVP: the SDPA forward of
    the shape stands beside each for scale. Returns (checks, a function of
    the further check: two runs of each kernel bit-equal)."""
    import torch
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    HEADS = G13.heads

    def view(n, std=1.0):             # rows past n of the buffer: NaN
        t = randn(B, n + 64, HEADS, DH, std=std)
        t[:, n:] = float("nan")
        return t[:, :n]

    q, dq = view(L, 3.0), view(L)
    self_kv = [view(L) for _ in range(4)]            # k, v, dk, dv
    text_kv = [view(TEXT) for _ in range(4)]
    lut = get_block_map(q, self_kv[0], TOPK, BQ, BK)[1]
    scale = DH ** -0.5
    pairs = _sparse_pairs(lut, BQ, BK, L, L)

    def without_mu(plain):
        def run():
            keep = fj._jvp_epilogue
            fj._jvp_epilogue = _epilogue_without_mu
            try:
                return plain()
            finally:
                fj._jvp_epilogue = keep
        return run

    def faults(kern):
        return {"mu left out of do": without_mu(lambda: kern(mu=False)),
                "P dv left out": lambda: kern(dv=0),
                "q dk^T left out of dS": lambda: kern(dk=0)}

    def dense(kv, n):
        def kern(dk=None, dv=None, mu=True):
            k, v, dk_, dv_ = kv
            dk_ = dk_ if dk is None else torch.zeros_like(dk_)
            dv_ = dv_ if dv is None else torch.zeros_like(dv_)
            if not mu:
                return fj.flash_attention_jvp_plain(q, k, v, dq, dk_, dv_,
                                                    scale, n)
            return fj._flash_jvp_cuda(q, k, v, dq, dk_, dv_, scale, n)
        return kern

    def sparse(dk=None, dv=None, mu=True, lut_=lut):
        k, v, dk_, dv_ = self_kv
        dk_ = dk_ if dk is None else torch.zeros_like(dk_)
        dv_ = dv_ if dv is None else torch.zeros_like(dv_)
        if not mu:
            return fj.sparse_flash_attention_jvp_plain(
                q, k, v, dq, dk_, dv_, lut_, BQ, BK, scale, L)
        return fj._sparse_flash_jvp_cuda(q, k, v, dq, dk_, dv_, lut_, BQ, BK,
                                         scale, L)

    k_self, k_text = dense(self_kv, L), dense(text_kv, TEXT)
    ops25 = lambda lk: {"bf16": 12 * B * HEADS * L * lk * DH}   # noqa: E731
    scale_sdpa = lambda kv: {"SDPA forward, for scale": sdpa(q, *kv[:2])}  # noqa: E731
    sel = lut.shape[-1]
    checks = [
        Check("K25", f"dense self {L}x{L} (o, do), rows past L NaN", k_self,
              lambda: fj.flash_attention_jvp_plain(q, *self_kv[:2], dq,
                                                   *self_kv[2:], scale, L),
              (q, dq, *self_kv), ops25(L), yardsticks=scale_sdpa(self_kv),
              atol=JVP_ATOL, faults=faults(k_self)),
        Check("K25", f"cross {L}x{TEXT} (o, do)", k_text,
              lambda: fj.flash_attention_jvp_plain(q, *text_kv[:2], dq,
                                                   *text_kv[2:], scale, TEXT),
              (q, dq, *text_kv), ops25(TEXT), yardsticks=scale_sdpa(text_kv),
              atol=JVP_ATOL, faults=faults(k_text)),
        Check("K26", f"sparse {sel}/{-(-L // BK)} blocks {BQ}/{BK} (o, do)",
              sparse, lambda: fj.sparse_flash_attention_jvp_plain(
                  q, *self_kv[:2], dq, *self_kv[2:], lut, BQ, BK, scale, L),
              (q, dq, *self_kv, lut), {"bf16": 12 * DH * pairs},
              yardsticks=scale_sdpa(self_kv), atol=JVP_ATOL,
              faults={**faults(sparse), "last LUT entry of every row dropped":
                      lambda: sparse(lut_=lut[..., :-1].contiguous())}),
    ]

    def extra():
        for name, kern in (("K25 self", k_self), ("K25 cross", k_text),
                           ("K26", sparse)):
            a, b = kern(), kern()
            torch.cuda.synchronize()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name}: two runs differ")
        print("phase2 K25/K26 stability: two runs of each (self, cross, "
              "sparse) bit-equal, with NaN in the rows past each length",
              flush=True)
    return checks, extra


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
           proj_l=None, batch: int = 1, block_scale: bool = False):
    """One full-width block of `geo`, card against CPU; returns the launch
    counts of its card run (set to 0 just before it, read just after).
    proj_l (default: on for sagesla at 256, off otherwise) makes it
    non-zero, so the linear branch runs: K6's kv sums and K7's epilogue on
    the channel path, K21 on the row and `sla` paths. quant_linear: the
    block's linears quantised as load_dit quantises them (W8A8 postscale,
    QKV fused below dim 4096), so the int8 feeds (K12-K14; K15-K17 at 14B)
    and the GEMMs K8-K11 run on the card and their plain versions on the
    CPU. block_scale: every linear W8A8 with 128x128 block scales instead
    (a reference checkpoint's layout, unfused): the bf16 composition with
    K22 for each linear. v_quant and sla_block as `make_wan_cfg` takes
    them; batch > 1 stacks independent random latents and contexts, and the
    card runs the block twice, bit-equal."""
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
    elif block_scale:
        quantize_wan_blocks([blk], mode="block", fuse_qkv=False)
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
             + (" + W8A8 block-scale" if block_scale else "")
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


GRAD_REL = 0.05   # a gradient's relative L2 error, bf16 block, card vs CPU


def phase3_train(device: str = "cuda"):
    """One full-width 1.3B `sla` block (linear branch on, proj_l != 0) at one
    480p latent frame, forward and backward: the card (K1-K4, K21 forward;
    K23 + K24 backward) against the plain versions on the CPU. The output
    on the Q blocks whose block-map rows agree, and the gradient of every
    parameter and of the inputs (x, the time modulation, the context), with
    the cotangent zero on the rows of Q blocks whose LUT rows differ, so
    both sides differentiate the same function. Returns the launch counts."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rmsnorm_rope, rope_cos_sin_full)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg(G13.model, "sla", TOPK)
    a = cfg.attention
    dev = torch.device(device)
    blk = _random_block(cfg, dev, seed=3, proj_l_std=0.05)
    blk_cpu = copy.deepcopy(blk).cpu()
    g = torch.Generator(device=dev).manual_seed(4)
    T, Hs, Ws = 1, 30, 52
    n = T * Hs * Ws
    x = torch.randn((1, n, G13.dim), generator=g, device=dev).bfloat16()
    e0 = 0.1 * torch.randn((1, 6, G13.dim), generator=g, device=dev)
    ctx = torch.randn((1, TEXT, G13.dim), generator=g, device=dev).bfloat16()
    cot = torch.randn((1, n, G13.dim), generator=g, device=dev).bfloat16()
    rope = rope_cos_sin_full(rope_freqs_3d(T, Hs, Ws, DH, device=dev))

    def lut_of(b, x, e0, rope):
        with torch.no_grad():
            e = b.modulation.float()[None] + e0
            h = modulated_layer_norm(x, e[:, 1:2], e[:, 0:1], eps=cfg.eps)
            sa = b.self_attn
            q = rmsnorm_rope(sa.q(h), sa.norm_q, *rope, num_heads=G13.heads,
                             eps=cfg.eps)
            k = rmsnorm_rope(sa.k(h), sa.norm_k, *rope, num_heads=G13.heads,
                             eps=cfg.eps)
            return get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]

    cpu = lambda *ts: tuple(t.cpu() for t in ts)  # noqa: E731
    same = (lut_of(blk, x, e0, rope).cpu().sort(-1).values
            == lut_of(blk_cpu, *cpu(x, e0), cpu(*rope)).sort(-1).values).all(-1)
    bad_q = sorted(set((~same).nonzero()[:, 2].tolist()))
    keep = torch.ones(n, dtype=torch.bool)
    for i in bad_q:
        keep[i * a.block_q:(i + 1) * a.block_q] = False
    if not keep.any():
        raise AssertionError("phase3 train: every Q-block's LUT differs")
    cot = cot * keep.to(dev)[None, :, None].to(cot.dtype)

    def run(b, x, e0, ctx, rope, cot):
        ins = [t.detach().requires_grad_() for t in (x, e0, ctx)]
        params = [p for _, p in b.named_parameters()]
        out = b(ins[0], ins[1], rope, ins[2])
        grads = torch.autograd.grad(out, ins + params, cot)
        return out.detach(), grads

    launchers = _launchers()
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, grads = run(blk, x, e0, ctx, rope, cot)
    torch.cuda.synchronize()
    ms_gpu = (time.perf_counter() - t0) * 1e3
    counts = {name: fn.launches for name, fn in launchers.items() if fn.launches}
    t0 = time.perf_counter()
    ref, ref_grads = run(blk_cpu, *cpu(x, e0, ctx), cpu(*rope), cot.cpu())
    ms_cpu = (time.perf_counter() - t0) * 1e3
    max_err, mean_err, _, want_mean, _ = _compare(
        "phase3 train block output", out.cpu()[:, keep], ref[:, keep],
        BLOCK_ATOL, BLOCK_RTOL)
    names = ["x", "e0", "context"] + [nm for nm, _ in blk.named_parameters()]
    rel = {}
    for nm, gg, gw in zip(names, grads, ref_grads):
        gg, gw = gg.float().cpu(), gw.float()
        if not bool(torch.isfinite(gg).all()):
            raise AssertionError(f"phase3 train: non-finite gradient of {nm}")
        rel[nm] = float((gg - gw).norm() / gw.norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL:
        raise AssertionError(f"phase3 train: gradient of {worst} off by "
                             f"{rel[worst]:.3g} (relative L2) > {GRAD_REL}")
    for lin in ("q", "k", "v", "proj_l"):
        if not grads[names.index(f"self_attn.{lin}.weight")].abs().max() > 0:
            raise AssertionError(f"phase3 train: zero gradient of {lin}")
    want = {"K1": 3, "K2": 3, "K3": 1, "K4": 1, "K21": 1, "K23": 1, "K24": 1}
    if counts != want:
        raise AssertionError(f"phase3 train launches {counts} != {want}")
    print(f"phase3 {G13.model} sla block forward + backward L={n} (proj_l != 0, "
          f"linear branch on): LUT rows equal as sets {int(same.sum())}/"
          f"{same.numel()} (Q-blocks left out: {bad_q}) | output max_abs_err "
          f"{max_err:.5g} mean_abs_err {mean_err:.5g} (|want| mean "
          f"{want_mean:.5g}) | gradients of {len(names)} tensors (x, e0, "
          f"context, {len(names) - 3} parameters): relative L2 error max "
          f"{rel[worst]:.4g} ({worst}), median "
          f"{statistics.median(rel.values()):.4g} (tol {GRAD_REL}) | card "
          f"{ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | launches {counts}",
          flush=True)
    return counts


JVP_REL = 0.05   # o's and do's relative L2 error, bf16 block, card vs CPU


def phase3_jvp(attention: str, device: str = "cuda"):
    """One full-width 1.3B block (`original`, or `sla` with proj_l != 0)
    at one 480p latent frame in the sCM tangent pass: `jvp_mode` and
    forward AD, with tangents on x and on the time modulation, as the
    student's tangent pass has them. The card (K25 for dense self and cross
    attention, K26 for sparse self attention; plain norms) against the plain
    versions on the CPU: o and do each within 5% relative L2, on the Q
    blocks whose block-map rows agree. Exact launch counts: dense K25 2;
    sla K26 1 and K25 1; no other kernel (K1-K4 and K21 have no tangent
    rule; the linear branch is plain torch there). Returns them."""
    import torch
    import torch.autograd.forward_ad as fwAD
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.models.wan import jvp_mode
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm_ref, rmsnorm_rope_ref, rope_cos_sin_full)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    sla = attention == "sla"
    cfg = make_wan_cfg(G13.model, attention, TOPK)
    a = cfg.attention
    dev = torch.device(device)
    blk = _random_block(cfg, dev, seed=7, proj_l_std=0.05 if sla else 0.0)
    blk_cpu = copy.deepcopy(blk).cpu()
    g = torch.Generator(device=dev).manual_seed(8)
    T, Hs, Ws = 1, 30, 52
    n = T * Hs * Ws
    x, dx = (torch.randn((1, n, G13.dim), generator=g, device=dev).bfloat16()
             for _ in range(2))
    e0, de0 = (0.1 * torch.randn((1, 6, G13.dim), generator=g, device=dev)
               for _ in range(2))
    ctx = torch.randn((1, TEXT, G13.dim), generator=g, device=dev).bfloat16()
    rope = rope_cos_sin_full(rope_freqs_3d(T, Hs, Ws, DH, device=dev))
    cpu = lambda *ts: tuple(t.cpu() for t in ts)  # noqa: E731

    def lut_of(b, x, e0, rope):
        with torch.no_grad():
            e = b.modulation.float()[None] + e0
            h = modulated_layer_norm_ref(x, e[:, 1:2], e[:, 0:1], eps=cfg.eps)
            sa = b.self_attn
            q, k = (rmsnorm_rope_ref(lin(h), w, *rope, cfg.eps) for lin, w in
                    ((sa.q, sa.norm_q), (sa.k, sa.norm_k)))
            return get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]

    keep, bad_q = torch.ones(n, dtype=torch.bool), []
    if sla:
        same = (lut_of(blk, x, e0, rope).cpu().sort(-1).values
                == lut_of(blk_cpu, *cpu(x, e0), cpu(*rope)).sort(-1).values
                ).all(-1)
        bad_q = sorted(set((~same).nonzero()[:, 2].tolist()))
        for i in bad_q:
            keep[i * a.block_q:(i + 1) * a.block_q] = False
        if not keep.any():
            raise AssertionError("phase3 jvp: every Q-block's LUT differs")

    def run(b, x, dx, e0, de0, ctx, rope):
        with torch.no_grad(), jvp_mode(b), fwAD.dual_level():
            out = b(fwAD.make_dual(x, dx), fwAD.make_dual(e0, de0), rope, ctx)
            o, do = fwAD.unpack_dual(out)
        return o, do

    launchers = _launchers()
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = run(blk, x, dx, e0, de0, ctx, rope)
    torch.cuda.synchronize()
    ms_gpu = (time.perf_counter() - t0) * 1e3
    counts = {nm: fn.launches for nm, fn in launchers.items() if fn.launches}
    t0 = time.perf_counter()
    want = run(blk_cpu, *cpu(x, dx, e0, de0, ctx), cpu(*rope))
    ms_cpu = (time.perf_counter() - t0) * 1e3
    rel = {}
    for nm, gg, ww in zip(("o", "do"), got, want):
        gg, ww = gg.float().cpu()[:, keep], ww.float()[:, keep]
        if not bool(torch.isfinite(gg).all()):
            raise AssertionError(f"phase3 jvp {attention}: non-finite {nm}")
        rel[nm] = float((gg - ww).norm() / ww.norm().clamp_min(1e-30))
        if rel[nm] > JVP_REL:
            raise AssertionError(f"phase3 jvp {attention}: {nm} off by "
                                 f"{rel[nm]:.3g} (relative L2) > {JVP_REL}")
    expect = {"K26": 1, "K25": 1} if sla else {"K25": 2}
    if counts != expect:
        raise AssertionError(f"phase3 jvp {attention} launches {counts} != "
                             f"{expect}")
    print(f"phase3 {G13.model} {attention} block, sCM tangent pass L={n}"
          f"{' (proj_l != 0)' if sla else ''}: o relative L2 error "
          f"{rel['o']:.4g}, do {rel['do']:.4g} (tol {JVP_REL}; |do| mean "
          f"{float(want[1].float().abs().mean()):.4g}; Q-blocks left out: "
          f"{bad_q}) | card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | "
          f"launches {counts}", flush=True)
    return counts


def _write_checkpoint(directory: str, block_scale: bool = True):
    """The port's writer saves a seeded random 1.3B sagesla DiT in the
    reference's checkpoint layout: every block linear quantised to 128x128
    block scales (`quantize_wan_blocks(mode="block", fuse_qkv=False)`;
    bf16 linears without block_scale, the training phase's teacher),
    proj_l N(0, 0.05^2) and the head N(0, 0.02^2) (non-zero: the linear
    branch runs and the velocity depends on the blocks), saved with
    convert's dtype rules (fp32 to bf16 but the scales). Returns the path
    and the state the port must load from it: the model's, fp32 tensors
    rounded through bf16 as the file stores them."""
    import torch
    from turbodiffusion_tpu_torch.models.wan import init_wan_params
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
    from turbodiffusion_tpu_torch.scripts.convert import save_state_dict
    from turbodiffusion_tpu_torch.utils.checkpoint import (
        wan_state_dict_from_params)
    t0 = time.perf_counter()
    cfg = make_wan_cfg(G13.model, "sagesla", TOPK)
    model = init_wan_params(cfg, seed=11, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        for p in [b.self_attn.proj_l for b in model.blocks] + [model.head.head]:
            std = 0.02 if p is model.head.head else 0.05
            for t in (p.weight, p.bias):
                t.copy_(std * torch.randn(t.shape, generator=g, device="cuda"))
    if block_scale:
        quantize_wan_blocks(model.blocks, mode="block", fuse_qkv=False)
    path = os.path.join(directory, f"dit_1.3b_sagesla_{'block' if block_scale else 'bf16'}.pth")
    save_state_dict(wan_state_dict_from_params(model, cfg), path)
    expected = {k: (v.bfloat16().float() if v.dtype == torch.float32
                    and not k.endswith("scale") else v)
                for k, v in model.state_dict().items()}
    print(f"phase4 checkpoint written: {os.path.getsize(path) / 2**30:.2f} GiB "
          f"in {time.perf_counter() - t0:.1f} s ({len(expected)} tensors)",
          flush=True)
    return path, expected


def phase4(label: str, geo: Geometry, attention: str, quant_linear: bool,
           requests: int, create_kw: dict, loaded_state=None):
    """`requests` 480p/81f requests through WanPipeline.create(geo.model,
    attention_type=attention, quant_linear=quant_linear, **create_kw), then
    a traced denoise (`_profile_denoise`); frees the pipeline and returns
    the launch counts of the last request. loaded_state: the DiT state the
    checkpoint in create_kw must load into, tensor for tensor."""
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
    if loaded_state is not None:
        got = pipe.dit.state_dict()
        bad = [k for k, v in loaded_state.items()
               if k not in got or not torch.equal(got[k], v)]
        if bad or len(got) != len(loaded_state) \
                or not pipe.cfg.attention.linear_branch:
            raise AssertionError(f"{label}: loaded DiT differs from the written "
                                 f"one at {bad[:5]} (linear branch "
                                 f"{pipe.cfg.attention.linear_branch})")
        print(f"phase4 {label} load: all {len(got)} tensors equal the written "
              f"model's (bf16 where the file is), linear branch on", flush=True)
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


# launches per training step of the 30-block 1.3B (student sla + teacher
# original): the student's forward K1 3, K2 3, K3 1, K4 1, K21 1 a block,
# twice under block_wise remat (the backward recomputes each block); its
# backward K23 1, K24 1 (K1, K2, K4 and K21 differentiate plain recomputes);
# the teacher's forward K1 3, K2 3, K4 2
TRAIN_LAUNCHES = {
    "block_wise": {"K1": 270, "K2": 270, "K3": 60, "K4": 120, "K21": 60,
                   "K23": 30, "K24": 30},
    "none": {"K1": 180, "K2": 180, "K3": 30, "K4": 90, "K21": 30, "K23": 30,
             "K24": 30},
}
TRAIN_FRAMES = {81: 21, 21: 6}    # clip frames -> latent frames


def _train_shards(directory: str):
    """Tar shards of seeded random samples at 480p 16:9, written with the
    port's writer: two of 81 frames (latents (16, 21, 60, 104)) and one of
    21 frames, each with a (512, 4096) text embedding. Returns {frames:
    shard glob}."""
    import torch
    from turbodiffusion_tpu_torch.training.data import write_tar_shard
    g = torch.Generator().manual_seed(31)
    out = {}
    for frames, n in ((81, 2), (21, 1)):
        samples = [{"latents": torch.randn((16, TRAIN_FRAMES[frames], 60, 104),
                                           generator=g),
                    "t5_text_embeddings": torch.randn((TEXT, 4096), generator=g),
                    "prompts": f"sample {i}"} for i in range(n)]
        sub = os.path.join(directory, f"data{frames}")
        write_tar_shard(os.path.join(sub, "shard-000000.tar"), samples)
        out[frames] = os.path.join(sub, "*.tar")
    return out


def _step_probe(label: str, want: dict, profile_step=None):
    """A trainer callback that, around each step, sets every launch count
    to 0 and reads it after (each must equal `want`), and measures the
    step's wall time (synchronised), peak memory and loss (finite); checks
    the q / k / v / proj_l gradients of the first and last block are
    non-zero; profiles step `profile_step`; and at the end checks that the
    weight matrices and fp32 parameters it watches moved. `.peaks` keeps each step's peak (GiB), `.counts` the
    last step's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from turbodiffusion_tpu_torch.training.trainer import Callback
    launchers = _launchers()
    want = {n: want.get(n, 0) for n in launchers}

    class Probe(Callback):
        def on_train_start(self, state):
            self.peaks, self.counts, self.prof = [], None, None
            blocks = state.params.blocks
            self.watch = {n: p for n, p in state.params.named_parameters()
                          if n.startswith(("blocks.0.self_attn", "head.head"))
                          or n.startswith(f"blocks.{len(blocks) - 1}.ffn")}
            self.before = {n: p.detach().clone() for n, p in self.watch.items()}

        def on_training_step_start(self, state, it):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in launchers.values():
                fn.launches = 0
            if it == profile_step:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
            self.t0 = time.perf_counter()

        def on_training_step_end(self, state, metrics, it):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            counts = {n: fn.launches for n, fn in launchers.items()}
            if counts != want:
                raise AssertionError(f"{label} step {it}: launches {counts} != "
                                     f"{want}")
            self.counts = {n: c for n, c in counts.items() if c}
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {it}: loss {loss}")
            model = state.params
            for i in (0, len(model.blocks) - 1):
                sa = model.blocks[i].self_attn
                for lin in (sa.q, sa.k, sa.v, sa.proj_l):
                    if lin.weight.grad is None or not lin.weight.grad.abs().max() > 0:
                        raise AssertionError(f"{label} step {it}: block {i} has "
                                             f"a zero q / k / v / proj_l gradient")
            phases = " | ".join(f"{k[:-3]} {float(v):.1f} ms" for k, v in
                                metrics.items() if k.endswith("_ms"))
            self.peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            line = (f"phase5 {label} step {it}: wall {wall * 1e3:.1f} ms ({phases}) "
                    f"| loss {loss:.6g} | grad norm "
                    f"{float(metrics['grad_norm']):.4g} | peak "
                    f"{self.peaks[-1]:.2f} GiB | launches {self.counts}")
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
                line += f"\nphase5 {label} profile of step {it}: " \
                    f"{_profile_summary(self.prof)}"
                self.prof = None
            print(line, flush=True)

        def on_train_end(self, state):
            # bf16 parameters move only where an update (~lr) reaches half a
            # bf16 step of the value, as with JAX's bf16 optax state: the
            # RMSNorm weights (all 1.0) do not at lr 1e-5; every weight
            # matrix and every fp32 parameter must
            moved = {n: int((p.detach() != self.before[n]).sum())
                     for n, p in self.watch.items()}
            still = [n for n, c in moved.items() if not c]
            must = [n for n in still if n.endswith("weight")
                    or self.watch[n].dtype == torch.float32]
            if must:
                raise AssertionError(f"{label}: parameters did not move: {must}")
            total = sum(p.numel() for p in self.watch.values())
            print(f"phase5 {label}: {len(self.watch) - len(still)} of "
                  f"{len(self.watch)} watched tensors moved (block 0 self-"
                  f"attention incl. proj_l, the last block's FFN, the head; "
                  f"{sum(moved.values())} of {total} elements); unmoved, their "
                  f"updates under half a bf16 step: {still}", flush=True)

    return Probe()


def _training_data(tmp: str):
    """Phase 5's and 6's inputs under `tmp`: a 1.3B teacher checkpoint the
    port's writer saves (bf16 linears, non-zero head and proj_l) and the tar
    shards of `_train_shards`. Returns (checkpoint path, {frames: glob})."""
    t0 = time.perf_counter()
    ckpt, _ = _write_checkpoint(tmp, block_scale=False)
    shards = _train_shards(tmp)
    print(f"phase5/6 data: teacher checkpoint and shards written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ckpt, shards


def phase5(tmp: str, ckpt: str, shards: dict):
    """SLA fine-tuning through the CLI (`scripts.train.main`, as `python -m
    turbodiffusion_tpu_torch.scripts.train --experiment sla` runs it) on
    `_training_data`'s teacher checkpoint and shards: (1) 3
    steps at 480p/81f, full width and depth, --remat block_wise, step 2
    profiled; (2) 1 step at 480p/21f, --remat none; (3) the checkpoint
    round trip at 2 layers, full width (21f): 1 step saved, then a run
    that resumes from it must start from the saved model, optimizer state
    and generator state and take step 2. Returns run 1's last step's
    launch counts."""
    import torch
    from turbodiffusion_tpu_torch.scripts import train
    from turbodiffusion_tpu_torch.training.trainer import Callback
    base = ["--experiment", "sla", "--model", G13.model, "--teacher_ckpt",
            ckpt, "--seed", "0", "--lr", "1e-5"]
    runs = [("block_wise 81f", 81, "block_wise", 3, 2),
            ("none 21f", 21, "none", 1, None)]
    peaks, counts = {}, None
    for label, frames, remat, steps, prof_step in runs:
        probe = _step_probe(label, TRAIN_LAUNCHES[remat], prof_step)
        t0 = time.perf_counter()
        train.main(base + ["--data", shards[frames], "--remat", remat,
                           "--max_iter", str(steps), "--ckpt_dir", "",
                           "--time_phases", "--", "trainer.log_every=1"],
                   callbacks=[probe])
        print(f"phase5 {label}: {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
        peaks[label] = max(probe.peaks)
        counts = counts or probe.counts
        gc.collect()
        torch.cuda.empty_cache()

    saved = {}

    class Keep(Callback):
        def on_train_end(self, state):
            saved["model"] = {n: t.detach().cpu().clone() for n, t in
                              state.params.state_dict().items()}
            saved["exp_avg"] = [state.opt_state.adamw.state[p]["exp_avg"]
                                .detach().cpu().clone()
                                for p in state.opt_state.params]

    class Resumed(Callback):
        def on_train_start(self, state):
            got = state.params.state_dict()
            bad = [n for n, t in saved["model"].items()
                   if not torch.equal(got[n].cpu(), t)]
            moms = [state.opt_state.adamw.state[p]["exp_avg"].cpu()
                    for p in state.opt_state.params]
            if bad or state.step != 1 or not all(
                    torch.equal(a, b) for a, b in zip(moms, saved["exp_avg"])):
                raise AssertionError(f"phase5 resume: step {state.step}, "
                                     f"model differs at {bad[:5]}")

    rt = base + ["--data", shards[21], "--ckpt_dir", os.path.join(tmp, "run"),
                 "--save_every", "1", "--", "model.num_layers=2"]
    t0 = time.perf_counter()
    train.main(rt[:-2] + ["--max_iter", "1"] + rt[-2:], callbacks=[Keep()])
    state = train.main(rt[:-2] + ["--max_iter", "2"] + rt[-2:],
                       callbacks=[Resumed()])
    size = os.path.getsize(os.path.join(tmp, "run", "iter_000000001.pth"))
    if state.step != 2:
        raise AssertionError(f"phase5 resume: ended at step {state.step}")
    print(f"phase5 checkpoint round trip (2 layers, full width): step 1 "
          f"saved ({size / 2**30:.2f} GiB: model, AdamW state, generator), "
          f"a second run resumed with every tensor and moment equal and "
          f"took step 2 | {time.perf_counter() - t0:.1f} s | peak "
          f"81f block_wise {peaks['block_wise 81f']:.2f} GiB, 21f none "
          f"{peaks['none 21f']:.2f} GiB", flush=True)
    return counts


# launches per rCM iteration of the 30-block 1.3B (n_sim 1, no negative
# prompt: one teacher forward per call site). Student iteration: 7 block
# forwards (the sCM teacher, the student and its block_wise recompute, the
# DMD student and its recompute, the fake score, the DMD teacher), each K1
# 3, K2 3, K4 2 (dense) or K3 1 + K4 1 + K21 1 (sla); the tangent pass K25
# on self and cross attention (dense) or K26 + K25 (sla) and nothing else;
# the backward of the two student graphs K23 + K24 (sla). Critic iteration:
# the simulated student, the fake score and its recompute
DISTILL_LAUNCHES = {
    "dense": ({"K1": 630, "K2": 630, "K4": 420, "K25": 60},
              {"K1": 270, "K2": 270, "K4": 180}),
    "sla": ({"K1": 630, "K2": 630, "K3": 210, "K4": 210, "K21": 210,
             "K23": 60, "K24": 60, "K26": 30, "K25": 30},
            {"K1": 270, "K2": 270, "K3": 90, "K4": 90, "K21": 90, "K23": 30,
             "K24": 30}),
}
# the tensors an rCM probe watches in each net: block 0's self-attention
# weight matrices, the last block's fc2, the head
_WATCH = ("blocks.0.self_attn.q.weight", "blocks.0.self_attn.o.weight",
          "blocks.29.ffn.fc2.weight", "head.head.weight")


def _distill_probe(label: str, launches, profile_iteration=None):
    """A trainer callback for `--experiment rcm`: around each iteration it
    sets every launch count to 0 and reads it after (each must equal the
    student's or the critic's of `launches`), measures the wall time
    (synchronised) and peak memory, checks the losses finite, and that the
    iteration moved what it trains (student and EMA, or fake score) and
    nothing else (the teacher never); profiles `profile_iteration`.
    `.counts` keeps each phase's launches, `.peaks` each iteration's peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from turbodiffusion_tpu_torch.training.trainer import Callback
    launchers = _launchers()

    def snap(state):
        nets = {"student": state.student, "fake": state.fake_score,
                "teacher": state.teacher}
        out = {k: {n: p.detach().clone() for n, p in m.named_parameters()
                   if n in _WATCH} for k, m in nets.items()}
        out["ema"] = {n: state.ema[n].clone() for n in out["student"]}
        return out

    class Probe(Callback):
        def on_train_start(self, state):
            self.peaks, self.counts, self.prof = [], {}, None

        def on_training_step_start(self, state, it):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.before = snap(state)
            for fn in launchers.values():
                fn.launches = 0
            if it == profile_iteration:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
            self.t0 = time.perf_counter()

        def on_training_step_end(self, state, metrics, it):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            student = metrics["student_phase"] == 1.0
            phase = "student" if student else "critic"
            want = launches[0 if student else 1]
            counts = {n: fn.launches for n, fn in launchers.items()}
            if counts != {n: want.get(n, 0) for n in launchers}:
                raise AssertionError(f"phase6 {label} iteration {it} ({phase}): "
                                     f"launches {counts} != {want}")
            self.counts[phase] = {n: c for n, c in counts.items() if c}
            keys = ("loss_cm", "loss_dmd") if student else ("loss_critic",)
            losses = {k: float(metrics[k]) for k in keys}
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"phase6 {label} iteration {it}: {losses}")
            after = snap(state)
            moved = {k: sum(int(not torch.equal(self.before[k][n], t))
                            for n, t in after[k].items()) for k in after}
            trained = {"student", "ema"} if student else {"fake"}
            wrong = [k for k, c in moved.items()
                     if c != (len(after[k]) if k in trained else 0)]
            if wrong:
                raise AssertionError(f"phase6 {label} iteration {it} ({phase}): "
                                     f"watched tensors moved {moved}")
            self.peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            phases = " | ".join(f"{k[:-3]} {float(v):.1f} ms" for k, v in
                                metrics.items() if k.endswith("_ms"))
            line = (f"phase6 {label} iteration {it} ({phase}): wall "
                    f"{wall * 1e3:.1f} ms ({phases}) | "
                    + " ".join(f"{k} {v:.6g}" for k, v in losses.items())
                    + f" | grad norm {float(metrics['grad_norm']):.4g} | peak "
                    f"{self.peaks[-1]:.2f} GiB | watched tensors moved "
                    f"{moved} | launches {self.counts[phase]}")
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
                line += (f"\nphase6 {label} profile of iteration {it}: "
                         f"{_profile_summary(self.prof)}")
                self.prof = None
            print(line, flush=True)

    return Probe()


def phase6(tmp: str, ckpt: str, shards: dict):
    """rCM distillation through the CLI (`scripts.train.main`, as `python -m
    turbodiffusion_tpu_torch.scripts.train --experiment rcm` runs it) on
    `_training_data`'s teacher checkpoint and 81f shards, full width and
    depth, --remat block_wise, lr 1e-5: (1) the dense (`original`) student,
    2 iterations (iteration 0 the student's, 1 the critic's); (2) `--
    model.attention.backend=sla`, the student's iteration, profiled; each
    through `_distill_probe`; (3) the DistillState round trip at 2 layers
    (21f): 1 iteration saved, then a run that resumes from it must start
    from the saved student, fake score, EMA, both AdamW states and
    generator and take iteration 2 (the critic's). Returns {dense, sla:
    the student iteration's launch counts}."""
    import torch
    from turbodiffusion_tpu_torch.scripts import train
    from turbodiffusion_tpu_torch.training.trainer import Callback
    base = ["--experiment", "rcm", "--model", G13.model, "--teacher_ckpt",
            ckpt, "--seed", "0", "--lr", "1e-5"]
    counts, peaks = {}, {}
    for label, ovr, iters, prof in (("dense", [], 2, None),
                                    ("sla", ["model.attention.backend=sla"], 1,
                                     0)):
        probe = _distill_probe(label, DISTILL_LAUNCHES[label], prof)
        t0 = time.perf_counter()
        state = train.main(base + ["--data", shards[81], "--remat",
                                   "block_wise", "--max_iter", str(iters),
                                   "--ckpt_dir", "", "--time_phases", "--",
                                   "trainer.log_every=1", *ovr],
                           callbacks=[probe])
        print(f"phase6 {label}: {iters} iterations in "
              f"{time.perf_counter() - t0:.1f} s with set-up", flush=True)
        counts[label], peaks[label] = probe.counts["student"], max(probe.peaks)
        del state
        gc.collect()
        torch.cuda.empty_cache()

    saved = {}

    def tensors(state):
        return {**{f"student.{n}": t for n, t in state.student.state_dict().items()},
                **{f"fake.{n}": t for n, t in state.fake_score.state_dict().items()},
                **{f"ema.{n}": t for n, t in state.ema.items()},
                **{f"m{i}": state.opt_student.adamw.state[p]["exp_avg"]
                   for i, p in enumerate(state.opt_student.params)}}

    class Keep(Callback):
        def on_train_end(self, state):
            saved.update({n: t.detach().cpu().clone()
                          for n, t in tensors(state).items()})

    class Resumed(Callback):
        def on_train_start(self, state):
            got = tensors(state)
            bad = [n for n, t in saved.items() if not torch.equal(got[n].cpu(), t)]
            if bad or state.step != 1:
                raise AssertionError(f"phase6 resume: step {state.step}, "
                                     f"differs at {bad[:5]}")

    rt = base + ["--data", shards[21], "--ckpt_dir", os.path.join(tmp, "rcm"),
                 "--save_every", "1", "--", "model.num_layers=2"]
    t0 = time.perf_counter()
    train.main(rt[:-2] + ["--max_iter", "1"] + rt[-2:], callbacks=[Keep()])
    state = train.main(rt[:-2] + ["--max_iter", "2"] + rt[-2:],
                       callbacks=[Resumed()])
    size = os.path.getsize(os.path.join(tmp, "rcm", "iter_000000001.pth"))
    if state.step != 2:
        raise AssertionError(f"phase6 resume: ended at iteration {state.step}")
    print(f"phase6 DistillState round trip (2 layers, full width): iteration "
          f"1 saved ({size / 2**30:.2f} GiB: student, fake score, EMA, two "
          f"AdamW states, generator), a second run resumed with all "
          f"{len(saved)} tensors equal and took iteration 2 (critic) | "
          f"{time.perf_counter() - t0:.1f} s | peak dense {peaks['dense']:.2f} "
          f"GiB, sla {peaks['sla']:.2f} GiB", flush=True)
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
    ("K22", ("int8_gemm_kernel<3>",)),
    ("K23", ("sparse_bwd_dq_kernel",)), ("K24", ("sparse_bwd_dkv_kernel",)),
    ("K25", ("flash_jvp_kernel<false>",)), ("K26", ("flash_jvp_kernel<true>",)),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("GEMM", ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")),
    ("top-k/sort", ("topk", "sort", "radix")), ("reduce", ("reduce",)),
]


def _profile_denoise(pipe, label: str):
    """The denoise phase of one warm request (4 DiT calls at 480p/81f) under
    torch.profiler: device time by kernel category and the device's idle
    share, as one printed line."""
    import torch
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
    print(f"phase4 {label} profile, denoise 4 DiT calls: wall {wall:.1f} ms, "
          f"{_profile_summary(prof)}", flush=True)


def _profile_summary(prof) -> str:
    """A profile's device window, idle share (1 - the union of kernel
    intervals over the window) and kernel time by category."""
    from torch.autograd import DeviceType
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
    return (f"device window {window / 1e3:.1f} ms, idle share "
            f"{1 - busy / window if window else 0:.3f}; kernel time "
            f"{total / 1e3:.1f} ms: {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6",
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
                 ("K5", "K6", "K7", "K12", "K13")),
                ("block-scale", dict(attention="sagesla", block_scale=True),
                 ("K1", "K2", "K4", "K5", "K6", "K7", "K22"))):
            block_counts[label] = phase3(**kw)
            missing = [n for n in must if not block_counts[label].get(n)]
            if missing:
                raise AssertionError(f"phase3 {label}: {missing} never launched")
        phase3("sagesla", True, geo=G14)
        phase3_train()
        for attention in ("original", "sla"):
            phase3_jvp(attention)
    counts = {}
    if 4 in phases:
        # a kernel's launches come from the 14B path (run last) where it
        # runs there, else from the first earlier path that runs it; K21,
        # which no request runs (random weights: proj_l = 0), from the
        # phase-3 block of the row path
        by_path = []
        for path in PATHS:
            if "dit_path" not in path[5]:
                by_path.append(phase4(*path))
                continue
            from turbodiffusion_tpu_torch.ops._build import BUILD_DIR
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                ckpt, state = _write_checkpoint(tmp)
                by_path.append(phase4(*path[:5], {**path[5], "dit_path": ckpt},
                                      loaded_state=state))
                del state
        for path_counts in by_path[-1:] + by_path[:-1]:
            for name, c in path_counts.items():
                counts[name] = counts.get(name) or c
        counts["K21"] = block_counts.get("row", {}).get("K21", 0)
    if phases & {5, 6}:
        from turbodiffusion_tpu_torch.ops._build import BUILD_DIR
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            data = _training_data(tmp)
            if 5 in phases:
                # the SLA path's kernels: one step's launches (run 1, last step)
                train_counts = phase5(tmp, *data)
                for name in ("K21", "K23", "K24"):
                    counts[name] = train_counts.get(name, 0)
            if 6 in phases:
                # the JVP kernels: one student iteration's launches (K25 the
                # dense student's, K26 the sla student's)
                distill_counts = phase6(tmp, *data)
                counts["K25"] = distill_counts["dense"]["K25"]
                counts["K26"] = distill_counts["sla"]["K26"]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts.get(n, 0), **kernels.get(n, {})}
        for n, (src, rep) in KERNELS.items()]}))
    print(smi)
    if phases != {1, 2, 3, 4, 5, 6}:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
