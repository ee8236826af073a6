"""Smoke run of the PyTorch port (`turbodiffusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --phases 1,2

Phases, each printing one line of its numbers:
  1. device and build: the card's name and power limit (nvidia-smi), the
     time to build the CUDA kernels from `turbodiffusion_tpu_torch/csrc/`
     and each kernel's ptxas registers (K1 / K12, K2, K5 and K16's row
     kernels and K6's and K21's reduces must not spill, nor the wgmma
     kernels, K14 / K17's `k14::cross_qout_kernel`, K4 / K3 / K20's
     `k4::flash_fwd_kernel<0>` / `<1>` / `<2>`, K7 / K28 / K19's
     `k7::sparse_i8_vt_kernel<0>` / `<1>` / `<2>`, K6's
     `k6::pack_kvt_kernel`, K21's `k21::kv_kernel` / `k21::apply_kernel`,
     K25 / K26's and K23 / K24's, spill or serialize their wgmmas: ptxas
     C7514);
  2. every kernel of the paths against its plain PyTorch version on the
     card, at the paths' shapes (480p/81f: 32,760 tokens, 512 text tokens,
     heads of 128, sagesla blocks 512/256; Wan2.1-1.3B: 12 heads, dim 1536,
     FFN 8960, 12 of 128 K blocks; K3 in its wgmma form (K4's kernel
     walking the LUT) at 512/256, on the path's q (its library call:
     `flex_attention` compiled with a BlockMask of the same LUT, where it
     compiles) and on a sharp q (std 3) rejecting three planted faults (the last LUT entry dropped, the scale
     doubled, v read from k), at 1.3B and 14B, and in its mma.sync form at
     512/64 (`sla` at --sla_block 64), each check asserting its form; K1
     and K2 in their warp-per-row form
     (each check asserts the form its launch takes), K1 also at batch 2
     with two modulations (rejecting batch 1's applied to batch 0), K2 with
     RoPE also on the fused QKV K column group (rows 3 x 1536 apart) and in
     its loop form (a view 2 bytes off alignment), rejecting the RoPE
     partner one vector off, the sin sign flipped and a weight channel
     doubled in the last vector a lane holds; K12 in its warp-per-row form
     (each check asserting it) as norm1 / norm2 and norm3, also at batch 2
     with the block's strided modulation, rejecting one row's modulation
     from the other batch, and at 5120 rejecting a row's scale taken from
     one warp's share; K5's three passes in their warp-per-row form (each
     check asserting it), the Q and K passes against the plain version fed
     the RMS each row took (which its own check holds to the plain
     statistic at rtol 1e-5: summed in another order, one ulp of it can
     move a bf16 step that RoPE's cancellation turns into two int8 steps),
     the Q pass at atol 1e-5 + rtol 2e-2 (its int8, scales and means),
     rejecting the first tile's rows left out of the first pool window's
     means, head 0's scale taken from head 1 (Q) and the RoPE partner one
     vector off (K); K10 and K11 also at a ragged M of 1,000 rows and
     at scale blocks / slabs of 384 and 1024 (K10's clusters of 3 and 8),
     and at both widths each rejecting a planted fault: a column scale
     doubled, a slab's row scales doubled; K9 also at a ragged M of 1,000
     rows, at K = 192 and at N = 1,152 (9 tiles), and at both widths
     rejecting a row scale doubled and the residual read one row off; K7
     also at blocks 128/128, at 32 of 128 K blocks (8,192 keys a row) and,
     at 40 heads, with the linear epilogue, rejecting the last LUT entry
     dropped and the V channel scales doubled; K18 and K19 of the v_quant="row" path
     (K19 in its wgmma form, K7's kernel with a K and a V scale a key, at
     512/256), K20 in its wgmma form (K4's kernel on int8 Q and K rows,
     64-key chunks) at blocks 64/64 with 51 of 512 K blocks, each check
     asserting its form, K21 in its wgmma form over the planes and over
     (B, L, H, D), its kv / ksum against float64 sums at rtol / atol 1e-4
     at 12 heads (planes, bf16 V past fp16's range: rejecting V through
     fp16 and a 64-row chunk left out) and 40 (views, int8-valued V:
     rejecting phi in two bf16 parts and the chunk left out), and its
     output's mean |o - float64| at most 1.1x the earlier fp32 kernel's on
     the same draws (`K21_PARENT_MEAN_ERR`); K6's
     kv against float64 sums as at 40 heads (below); K4 also at batch 2, at a ragged Lq of 1,000, at
     kv_len 500 of 512 with NaN in k and v past it, with q, k and v read in
     place as fused-QKV column groups (q sharp, rejecting the scale
     doubled), and on a sharp q rejecting three planted faults (v read from
     k, the scale doubled, the last 128-key chunk dropped); K22 at the
     block-scale checkpoint path's GEMM shapes in bf16 and at 1536 x 1536
     and a ragged shape in fp32, bit-equal, the last two (and the 14B's
     ragged M) with xs ending where mapped memory ends; then the Wan2.1-14B forms: K1 at 5120 (affine, mod, bare); K2 at H*Dh 5120, norm only and
     with RoPE, each with planted faults a kernel that stopped at 4096
     would give (channels past 4096 left NaN, weight channel 4100 doubled)
     and, with RoPE, the three above,
     and above 5120 at 48 x 128; K14 (12 heads) and K17 (40 heads) also on
     a sharp q (one key of 512 dominates each row, in either half of the
     keys), rejecting two planted faults (the scale from one block's heads
     only, the second key half's row max ignored), at a ragged Lq of 1,000
     with kv_len 300, at batch 2 with q a column slice and at kv_len 1,100
     (two passes); K3 and K4 (cross and dense self,
     SDPA beside it) at 40 heads, K4 also dense at 720p (75,600 tokens, q
     sharp);
     K15, K5's three passes at 40 heads with the row's own RMS (as the
     path takes it; the same faults) and its Q pass with K15's RMS (the
     external-RMS mode), K6 (also with the linear branch's kv sums, rejecting
     one run's partial left out of a head's kv, its ksum alone at atol
     5e-4, rejecting a row past kv_len let into phi and ksum from phi's fp16
     hi half only, and its kv against float64 sums at rtol 1e-4 / atol 1e-4,
     rejecting kv from phi's fp16 hi half only and phi split into bf16 hi +
     lo), K7, K16 (bit for bit, on planes whose first rows land on
     half-integers, rejecting a row's scale taken from its neighbour and the
     ties rounded away from even), K17, K12, K8-K11 and
     K22 (also at a ragged M of 1,000) at dim 5120, FFN 13824; every
     int8 GEMM line with its TOP/s and share of the int8 peak), with
     poisoned-tail checks of K7, K19 (NaN K and V scales past kv_len), K20
     (NaN k and v rows past a kv_len of 30,000: the output bit-equal) and
     K21: max absolute error under the
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
     block-sparse backward, at the 1.3B training shape in both forms of
     their kernel (128-row tiles at 512/256, 64-row tiles at 64/64, each
     check asserting its form; q of std 3, a K-block no Q-block selects,
     NaN in the buffers' rows past L; planted faults: K23 acc2's term left
     out, the last LUT entry of every row dropped, dq without `scale`; K24
     an inverse-LUT entry dropped, delta left out of dS, dk without
     `scale`; (lse, delta) in fp32, K24 ignoring their rows past L, dk = dv
     = 0 on the unselected block, two runs bit-equal; no library call: the
     dense SDPA backward of the shape beside them for scale), and K24's
     check over 8 more draws of its inputs, each draw's worst error as a
     share of the tolerance printed; then K25 / K26,
     forward-mode attention (o and its tangent do), at the training shape:
     K25 self 32,760 x 32,760 and cross 32,760 x 512, K26 at 512/256 with
     12 of 128 K-blocks, all three in the wgmma form, and K26 at 64/64 (51
     of 512 K-blocks) in its mma.sync form (q of std 3, tangents the size of the primals, NaN
     in the rows past each length; atol 0.1 + rtol 2e-2; planted faults: mu left out of do, P dv
     left out, q dk^T left out of dS, K26's last LUT entry dropped; two runs
     bit-equal; no library call: the SDPA forward of the shape beside them);
     then K27-K30 (`_last_checks`): K27 block-scale pack with K rows past
     L of 1e4, then NaN (1 LSB, scales bit-equal; faults: the statistic
     over the rows past L, scales one block off), K28 in its wgmma form
     (K7's kernel on the packed K|V rows) at 512/256 on the
     topk-0.3 LUT (38 of 128 K blocks; SHARP_ATOL; faults: a LUT entry
     dropped, the scale table shifted a block, vch left out; a poisoned
     tail; K7 on the same LUT beside it), K29 (1 LSB; fault: mu left out),
     K30 dense int8-QK self 32,760 x 32,760 (K4's kernel in its dense
     int8-QK form; faults: one K row's scale doubled, kv_len 64 keys short;
     SDPA and K4 with bf16 QK on the same tensors beside it), each run twice
     bit-equal;
  3. one full-width `WanAttentionBlock` with seeded random non-zero weights
     at one 480p latent frame (1,560 tokens): at 1.3B `sla`, `sagesla`,
     `sagesla` with W8A8 linears and `sla` with W8A8 linears (the sagesla
     blocks with a non-zero `proj_l`, so the fused linear epilogue runs; the
     W8A8 blocks take the int8 feeds K12-K14), W8A8 `sagesla` at
     v_quant="row" with a non-zero `proj_l` (K18, K19, K21 over the planes),
     W8A8 `sagesla` at blocks 64/64 (K20), bf16 `sla` with a non-zero
     `proj_l` (K21 over (B, L, H, D)), W8A8 `sagesla` at batch 2,
     `sagesla` with 128x128 block-scaled linears and a non-zero `proj_l`
     (the bf16 composition, K22 for each linear) and W8A8 `sagesla` in the
     block-scale branch (6 latent frames, 9,360 tokens, topk 0.9: 33 of 37
     K blocks, 8,448 keys a row > 8,192; proj_l != 0: exactly K27 1, K28 1,
     K21 1, K6 0, K7 0), and at 14B `sagesla`
     with W8A8 linears (unfused Q / K / V, K15-K17), bf16 `sagesla` (K5-K7
     with the rows' RMS in K5, K2 on the cross q; no K15), `sla` (K2 on q, k and the cross q, K3),
     `original` (K2, K4) and `sagesla` with block-scaled linears (K22): the
     kernels on the card against the plain versions on the CPU, on the Q
     blocks whose block-map rows agree as sets, with each block's launch
     counts; then three 1.3B blocks (proj_l != 0) forward and backward,
     card against CPU: `sla` (K23 + K24), bf16 `sagesla` on the fused path
     (the composable VJP: K2 2, K21 1, K23 1, K24 1 in the backward, no K20)
     and `sagesla` at 64/64 (K20, straight-through K23 + K24): the output
     and the gradients of every parameter and the 3 inputs, each within 5%
     relative L2 and none zero, exact launches of forward and backward
     (K21's earlier JSON source: random weights give the requests a
     zero `proj_l`); then one 1.3B `original` and one `sla` block (proj_l !=
     0) in the sCM tangent pass (forward AD, `jvp_mode`), card (K25, K26)
     against CPU: o and do each within 5% relative L2, launches exactly K25
     2 (dense) or K26 1 + K25 1 (sla), each in the wgmma form;
  4. the paths: `WanPipeline.create(..., attention_type="sagesla",
     quant_linear=True)` with random weights and two 480p/81f 4-step
     `generate_t2v` requests, then one request each of bf16 `sagesla` and
     `sla`, one W8A8 `sagesla` request at v_quant="row" and one at
     sla_block=64, one W8A8 `sagesla` request at sla_topk=0.3 (the
     block-scale pair), then one request of `WanPipeline.create(dit_path=...)`
     on a 1.3B sagesla checkpoint that the port's writer saves first (block-
     scaled linears, non-zero `proj_l` and head; the loaded DiT must equal
     the written one tensor for tensor), then, each pipeline freed before
     the next, Wan2.1-14B: two W8A8 `sagesla` requests, two bf16 `sagesla`,
     one bf16 `sla`, one bf16 `original`, one from a block-scaled DiT made
     on the card and passed to `create` as a state dict (the loaded DiT must
     equal it), and one bf16 `sagesla` at 720p (1280 x 720); per request the
     text-encode, denoise and VAE-decode times, each phase's peak device
     memory and the VAE decode's own rise (at most 16 GiB at 480p), and the
     launch count of every kernel, set to 0 just before the request and
     read just after (1.3B W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 6, K10
     1, K11 1, K12 3, K13 1, K14 1 per block; bf16 sagesla: K1 3, K2 1, K4
     1, K5 3, K6 1, K7 1; sla: K1 3, K2 3, K3 1, K4 1; W8A8 row: K5 3, K8 2,
     K9 6, K10 1, K11 1, K12 3, K13 1, K14 1, K18 1, K19 1; W8A8 block 64:
     K2 2, K8 3, K9 6, K10 1, K11 1, K12 3, K14 1, K20 1; W8A8 topk 0.3:
     K5 3, K8 2, K9 6, K10 1, K11 1, K12 3, K13 1, K14 1, K27 1, K28 1;
     checkpoint: K1
     3, K2 1, K4 1, K5 3, K6 1, K7 1, K22 10; x 30 blocks x 4 steps; 14B
     W8A8 sagesla: K5 3, K6 1, K7 1, K8 2, K9 8, K10 1, K11 1,
     K12 3, K15 1 (the cross q), K16 1, K17 1; 14B bf16 sagesla (480p and
     720p): K1 3, K2 1, K4 1, K5 3, K6 1, K7 1; `sla`: K1 3, K2 3, K3 1, K4 1;
     `original`: K1 3, K2 3, K4 2; block-scaled: bf16 sagesla's and K22
     10; x 40 blocks x 4 steps; every other kernel 0), which shows each
     path went through its kernels; then one DiT call of each path under
     torch.profiler: device time by kernel category and the device's idle
     share;
  5. SLA fine-tuning through the training CLI (`scripts.train.main
     --experiment sla`) from a 1.3B teacher checkpoint the port's writer
     saves first (non-zero head and proj_l) and tar shards written here:
     3 steps at 480p/81f, full width and depth, --remat block_wise (per
     step: wall time and its teacher / forward / backward / optimizer
     split, loss, peak memory, exact launches K1 270, K2 270, K3 60, K4
     120, K21 60, K23 30, K24 30; non-zero q / k / v / proj_l gradients;
     step 2 under torch.profiler), 1 step at 480p/21f, --remat none (K1
     180, K2 180, K3 30, K4 90, K21 30, K23 30, K24 30), 1 step of a
     sagesla student at 480p/21f, --remat none (`-- model.attention.backend
     =sagesla`, the teacher's too, so the student's head starts N(0,
     0.02^2) apart, else the loss is exactly 0: K1 180, K2 120, K4 60, K5
     180, K6 60, K7 60, K21 30, K23 30, K24 30; finite loss and gradient
     norm, non-zero q / k / v / proj_l gradients, moved weights), and the
     checkpoint save -> resume round trip at 2 layers;
  6. rCM distillation through the training CLI (`scripts.train.main
     --experiment rcm`) from phase 5's teacher checkpoint and 81f shards,
     full width and depth, --remat block_wise: the dense student's
     iteration 0 (sCM + DMD + EMA; launches K1 630, K2 630, K4 420, K25 60)
     and iteration 1 (the critic's; K1 270, K2 270, K4 180), then with `--
     model.attention.backend=sla` the student's iteration (K1 630, K2 630, K3
     210, K4 210, K21 210, K23 60, K24 60, K26 30, K25 30; profiled) and the
     critic's (K1 270, K2 270, K3 90, K4 90, K21 90, K23 30, K24 30); per
     iteration the wall time and its split, the losses (finite), peak
     memory, exact launches, and the watched weights of what it trains
     moved (student and EMA, or fake score) and of nothing else (the
     teacher never); then the DistillState save -> resume round trip at 2
     layers.
Then one JSON line with every kernel's numbers (a kernel a 14B path runs:
its 14B checks and the first such path's launches; K21, K23, K24: their 1.3B checks
and one training step's launches; K25, K26: one student iteration's of
phase 6 (dense, sla); K29, K30: their checks and 0 launches, as no path
reaches them, in JAX either; any other: its 1.3B checks and the
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

# torch.compile (K3's library yardstick, phase 2) compiles in this process:
# no pool of compile workers outlives the run
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")


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
L720 = 75600                        # 720p/81f tokens (1280 x 720)
ATOL, RTOL = 2e-2, 2e-2           # bf16 kernel vs plain version on the card
# K19-K21: outputs of order 0.03 (K19, K20: near-flat softmax over ~3,000
# keys) to 1 (K21's inputs); an atol a fifth of ATOL fails each planted fault
SHARP_ATOL = 4e-3
# K21's output against the float64 branch on the draws of `k21_f64_inputs`:
# the mean |o - float64| that K21's earlier fp32 kernel (CUDA cores, before
# its wgmma design) gave there (`python tools/time_k21.py --smoke --root
# <that checkout>`, H100 80GB HBM3, 700 W); the check holds the kernel to at
# most 1.1x of it
K21_PARENT_MEAN_ERR = {"planes-12-beyond": 15.982605682560513,
                       "bhld-40-int8": 0.0004563855515251652}
# K25 / K26's do = acc_t / l - mu o subtracts terms of up to ~25 (q of std
# 3) whose bf16-rounded P dS the kernel rounds at the running max of the
# online softmax and the plain version at the row's final max, as the TPU
# kernel and its jnp reference do: ~2^-8 x 25 = 0.1 absolute; the planted
# faults miss by 4 and more
JVP_ATOL = 0.1
SCALE_RTOL = 1e-5                   # fp32 int8 scales, kernel vs plain
# K5's Q pass (int8 planes, scales, pooled means, no bf16 plane): atol 1e-5
# with RTOL, the card tests' tolerance of K5's scales and means (a one-ulp
# RMS can move one bf16 step of a head's absmax, 2^-8 relative); ATOL would
# pass a head's scale taken from its neighbour's
K5_Q_ATOL = 1e-5
# K14's scales: its fp32 sums (the row's mean square, QK, P V) run in another
# order than the plain version's, which can move one bf16 element of the
# normed q or of P by a step (2^-8) and so the row's output absmax by up to
# ~p_j * 2^-8 / l of it (a few 1e-3 where one key dominates the row)
K14_SCALE_RTOL = 5e-3
BLOCK_ATOL, BLOCK_RTOL = 0.1, 0.05  # bf16 block, card vs CPU (other GEMMs)
BQ, BK, TOPK = 512, 256, 0.1        # sagesla / sla blocks and top-k ratio
TOPK_BS = 0.3      # the block-scale pair's path: 38 of 128 K blocks
LP = -(-L // 512) * 512             # the fused path's padded length
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): a
# kernel's bound is the larger of its bytes over HBM and the sum over types
# of its operations over the type's peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# launches per request: blocks x 4 steps x per-block calls (1.3B: 30
# blocks, 14B: 40); a kernel a path does not name runs 0 times
_SAGESLA = {"K5": 360, "K6": 120, "K7": 120}
_SAGESLA_14B = {"K1": 480, "K2": 160, "K4": 160, "K5": 480, "K6": 160,
                "K7": 160}
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
    # the wide forms: unfused Q / K / V (K9 x 8), K5 taking each row's RMS
    # itself, K15 on the cross q for K17 (cross attention), K16 for the O
    # feed
    "14b-sagesla+w8a8": {"K5": 480, "K6": 160, "K7": 160, "K8": 320,
                         "K9": 1280, "K10": 160, "K11": 160, "K12": 480,
                         "K15": 160, "K16": 160, "K17": 160},
    # a reference-layout checkpoint with 128x128 block-scaled linears: the
    # bf16 sagesla composition (K1 x 3, K2 on the cross q, K4) with each of
    # the ten linears a K22, and the linear branch on (a non-zero proj_l:
    # K6's linear kv, K7's linear epilogue)
    "1.3b checkpoint": {**_SAGESLA, "K1": 360, "K2": 120, "K4": 120,
                        "K22": 1200},
    # topk 0.3: sel = int(0.3 * 128) = 38 K blocks, 38 x 256 = 9,728 keys a
    # row > 8,192, so the fused path takes JAX's block-scale pair: K27
    # packs K|V with one K scale a block, K28 attends
    "sagesla+w8a8 topk0.3": {"K5": 360, "K8": 240, "K9": 720, "K10": 120,
                             "K11": 120, "K12": 360, "K13": 120, "K14": 120,
                             "K27": 120, "K28": 120},
    # the 14B with bf16 linears: K1 x 3, K2 on the cross q at 5120 and K4
    # over the text; fused sagesla K5 x 3 (the RMS in the row), K6, K7; `sla`
    # and `original` K2 on the self q and k too, then K3 or K4
    "14b-sagesla": _SAGESLA_14B,
    "14b-sla": {"K1": 480, "K2": 480, "K3": 160, "K4": 160},
    "14b-original": {"K1": 480, "K2": 480, "K4": 320},
    # 128x128 block-scaled linears keep the bf16 composition, each of the
    # ten linears a K22
    "14b-block-scale": {**_SAGESLA_14B, "K22": 1600},
    "14b-sagesla 720p": _SAGESLA_14B,
}
# the largest rise of a 480p/81f request's VAE decode above the allocation
# at its start: the HBM of the TPU v5e the JAX package decodes it on
VAE_OWN_PEAK_MAX_GIB = 16.0
REPS = 5          # timed runs of each kernel (plain versions: REPS // 2)
# phase-4 paths in the order run: (label, geometry, attention, quant_linear,
# requests, other WanPipeline.create arguments and "resolution"); each
# pipeline is freed before the next; the 14B paths run last and their counts
# fill the JSON line first
PATHS = [("sagesla+w8a8", G13, "sagesla", True, 2, {}),
         ("sagesla", G13, "sagesla", False, 1, {}),
         ("sla", G13, "sla", False, 1, {}),
         ("sagesla+w8a8 row", G13, "sagesla", True, 1, {"v_quant": "row"}),
         ("sagesla+w8a8 block64", G13, "sagesla", True, 1, {"sla_block": 64}),
         ("sagesla+w8a8 topk0.3", G13, "sagesla", True, 1, {"sla_topk": TOPK_BS}),
         # dit_path: a checkpoint the port's writer saves first
         ("1.3b checkpoint", G13, "sagesla", False, 1, {"dit_path": None}),
         ("14b-sagesla+w8a8", G14, "sagesla", True, 2, {}),
         ("14b-sagesla", G14, "sagesla", False, 2, {}),
         ("14b-sla", G14, "sla", False, 1, {}),
         ("14b-original", G14, "original", False, 1, {}),
         # dit_path: a block-scaled DiT's state dict, made on the card
         ("14b-block-scale", G14, "sagesla", False, 1, {"dit_path": "block"}),
         ("14b-sagesla 720p", G14, "sagesla", False, 1, {"resolution": "720p"})]

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
    "K27": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:501"),
    "K28": ("turbodiffusion_tpu_torch/csrc/sparse_i8_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1363"),
    "K29": ("turbodiffusion_tpu_torch/csrc/sla_fused.cu",
            "turbodiffusion_tpu/ops/sla_fused.py:533"),
    "K30": ("turbodiffusion_tpu_torch/csrc/flash_attention.cu",
            "turbodiffusion_tpu/ops/flash_pallas.py:1139"),
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
            "K25": fj._flash_jvp_cuda, "K26": fj._sparse_flash_jvp_cuda,
            "K27": sf._subquant_pack_kv_blocks_cuda,
            "K28": si8._sparse_i8_planes_bs_cuda,
            "K29": sf._subquant_planes_cuda, "K30": fa._flash_i8qk_cuda}


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
    lsb: int = 1                          # int8 outputs: the largest difference
    extra_bytes: int = 0                  # bytes the design moves besides ins and outputs


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


def _compare(name, got, want, atol, rtol, lsb: int = 1):
    """(max abs error, mean abs error, int8 LSB difference, mean |want|,
    max |want|); raises past atol + rtol * |want|, or past `lsb` LSB for
    int8 outputs. Tuples and dicts compare element by element and give the
    worst (largest) of each."""
    import torch
    if isinstance(got, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: outputs {sorted(got)} != {sorted(want)}")
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]
    if isinstance(got, (tuple, list)):
        errs = [_compare(name, a, b, atol, rtol, lsb) for a, b in zip(got, want)]
        return tuple(max(e[i] for e in errs) for i in range(5))
    if got.dtype == torch.int8:
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        d = int((got.int() - want.int()).abs().max())
        if d > lsb:
            raise AssertionError(f"{name}: int8 output off by {d} LSB")
        wa = want.float().abs()
        return 0.0, 0.0, d, float(wa.mean()), float(wa.max())
    # a float64 reference (exact sums) is compared in float64
    dt = torch.float64 if want.dtype == torch.float64 else torch.float32
    got, want = got.to(dt), want.to(dt)
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
    ptxas = _ptxas_summary(lib.build_log)
    print(f"phase1 device: {smi} | kernel build {lib.build_seconds:.1f} s "
          f"(load {wall:.1f} s) | ptxas: {ptxas}", flush=True)
    # K1 / K12, K2 and K5's warp-per-row kernels hold their rows in
    # registers; K14 /
    # K17's, K3 / K4 / K20's and K7 / K19 / K28's hold their S and O there,
    # and their wgmmas must overlap
    spilled = [k for k in ptxas.split("; ") if k.startswith(_ROW_KERNELS + _WGMMA_KERNELS)
               and (" spill" in k or " stack" in k)]
    if spilled:
        raise AssertionError(f"phase1: kernels spill: {spilled}")
    serialized = [k for k in ptxas.split("; ")
                  if k.startswith(_WGMMA_KERNELS) and "wgmma serialized" in k]
    if serialized:
        raise AssertionError(f"phase1: wgmma serialized (C7514): {serialized}")
    return smi


_ROW_KERNELS = ("mln_rows_kernel", "rmsrope_rows_kernel", "head_planes_rows_kernel",
                "unfold_quant_wide_kernel", "k6::kv_reduce_kernel", "k21::kv_reduce_kernel")
_WGMMA_KERNELS = ("k14::cross_qout_kernel", "k4::flash_fwd_kernel", "k7::sparse_i8_vt_kernel",
                  "k6::pack_kvt_kernel", "k25::jvp_fwd_kernel", "kbwd::bwd_kernel",
                  "k21::kv_kernel", "k21::apply_kernel")


def _kernel_name(mangled: str) -> str:
    """`head_planes_kernel<4>` (or `ffn::w8a8_ffn_kernel<2>`) from the
    mangled name of a kernel in a (per-file anonymous) namespace, its bool /
    int template arguments decoded."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]          # past the namespace
    parts = []
    while m := re.match(r"(\d+)", rest):               # nested names
        n = int(m.group(1))
        parts.append(rest[m.end():m.end() + n])
        rest = rest[m.end() + n:]
    if not parts:
        return mangled
    name, args = "::".join(parts), re.match(r"I((?:L[bi]\d+E)+)E", rest)
    if args:
        vals = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
        name += f"<{', '.join(vals)}>"
    return name


def _ptxas_summary(log: str) -> str:
    """`kernel<args> N regs[, F B stack][, S B spill][, wgmma serialized]`
    for each kernel entry of nvcc's -Xptxas -v output (empty when nothing
    was built in this process); a stack frame is a local array the
    registers did not hold; "wgmma serialized" is ptxas's C7514 (each
    wgmma waits for the one before: no product overlaps other work)."""
    out, name, spill = [], None, ""
    serialized = set(re.findall(r"\(C7514\).*?in the function '(\w+)'", log))
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
            if m.group(1) in serialized:
                spill += ", wgmma serialized"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name and int(m.group(1)):
            spill += f", {m.group(1)} B stack"
        if m and name and int(m.group(2)):
            spill += f", {m.group(2)} B spill"
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
    pairs7 = _sparse_pairs(lut8, BQ, BK, L, L)
    # the statistic each K5 pass took: its plain version is fed it (see
    # _k5_rms), the statistic itself checked against the plain one
    rms_q = _k5_rms(xq, w, cosF, sinF, HEADS, BQ, True, False)
    rms_k = _k5_rms(xk, w, cosF, sinF, HEADS, BK, False, True)
    ops4 = lambda lk: {"bf16": 4 * B * HEADS * L * lk * DH}      # noqa: E731
    ops7 = {"int8": 2 * DH * pairs7, "bf16": 2 * DH * pairs7}   # QK, PV
    kv_ops = 2 * B * HEADS * L * DH * DH          # K6's kv sums, a product (hi and lo: 2)
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
              (x, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x},
              faults=_k2_rope_faults(x, w, cosF, sinF, HEADS)),
    ] + _norm_form_checks(randn, x, w, bias, ms, mb, cosF, sinF, HEADS) + _k3_checks(
        q, k, v, lut, topk, HEADS) + [
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
    ] + _k4_edge_checks(q, kt, vt, sdpa) + [
        Check("K5", f"Q (norm+rope, int8, pool 512) {_k5_form(xq, w, cosF, sinF, HEADS)}",
              lambda: sf._head_planes_cuda(xq, q_form["weight"], cosF, sinF, HEADS,
                                           1e-6, BQ, True, False, LP),
              lambda: sf.head_planes_plain(xq, **q_form, **hp, rms_inv=rms_q),
              (xq, w, cosF[:L], sinF[:L]), {"fp32": 12 * n_x}, atol=K5_Q_ATOL,
              faults=_k5_faults(xq, w, cosF, sinF, HEADS, BQ, True, False)),
        Check("K5", f"K (norm+rope, bf16, pool 256) {_k5_form(xk, w, cosF, sinF, HEADS)}",
              lambda: sf._head_planes_cuda(xk, w, cosF, sinF, HEADS, 1e-6, BK,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xk, **k_form, **hp, rms_inv=rms_k),
              (xk, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x},
              faults=_k5_faults(xk, w, cosF, sinF, HEADS, BK, False, True)),
        Check("K5", "the Q rows' RMS inverse the kernel took",
              lambda: _k5_rms(xq, w, cosF, sinF, HEADS, BQ, True, False),
              lambda: sf.row_rms_inv_plain(xq, 1e-6), (xq, w, cosF[:L], sinF[:L]),
              {"fp32": 12 * n_x}, atol=0.0, rtol=SCALE_RTOL),
        Check("K5", f"V (bf16 fold) {_k5_form(xv, None, None, None, HEADS)}",
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
              (Kp["bf16"], k_mean, vi), {"fp32": 4 * n_x, "bf16": 2 * kv_ops},
              extra_bytes=_kvt_partial_bytes(B, HEADS, LP, BK)),
        _k6_kv_exact_check(Kp["bf16"], k_mean, vi, ""),
        Check("K7", f"int8 sparse ({sel}/{LP // BK} blocks) {BQ}/{BK}",
              k7(si8._sparse_i8_vt_cuda),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw),
              i8_args, ops7, faults=_k7_faults(i8_args, scale)),
        Check("K7", "int8 sparse + linear epilogue",
              k7(si8._sparse_i8_vt_cuda, **lin),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, **i8_kw, **lin),
              i8_args + tuple(lin.values()), ops7),
    ] + (_k7_edge_checks(q, k, Qp, Kp, k_mean, vi, vcs) + _w8a8_checks(randn, x, G13)
         + _int8_feed_checks(randn, x, ms, mb, w, bias, kt, vt, sdpa))
    mode_checks, tails = _mode_checks(randn, Qp, Kp, k_mean, xv, lut8, q, k, v)
    k21_checks, k21_means = _k21_f64_checks()
    bwd_checks, bwd_extra = _bwd_checks(randn)
    jvp_checks, jvp_extra = _jvp_checks(randn, sdpa)
    last_checks, last_extra = _last_checks(randn, xq, w, cosF, sinF, Kp,
                                           k_mean, Vp, k, v, sdpa)
    results = _run_checks(checks + mode_checks + k21_checks + _block_gemm_checks(randn)
                          + bwd_checks + jvp_checks + last_checks, reps)
    _poisoned_tail(i8_args, scale)
    for tail in (*tails, bwd_extra, _k24_seeds, jvp_extra, last_extra, k21_means):
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
            f"{c.name} {c.what}", got, want, c.atol, c.rtol, c.lsb)
        bound_ms, bound_by = _bound(_nbytes(c.ins) + _nbytes(got) + c.extra_bytes, c.ops)
        for what, fault in c.faults.items():
            _must_fail(f"{c.name} {c.what}", what, fault(), want, c.atol, c.rtol, c.lsb)
        del got, want
        ms_k = _time_ms(c.kern, reps)
        ms_p = _time_ms(c.plain, max(2, reps // 2))
        lib_ms = _time_ms(c.library, reps) if c.library else None
        extra = "".join(f" | {what} {_time_ms(fn_, reps):.4f} ms"
                        for what, fn_ in c.yardsticks.items())
        lib = (f" | library {c.library_what} {lib_ms:.4f} ms" if c.library
               else " | library none")
        if set(c.ops) == {"int8"}:       # the int8 GEMMs: rate and peak share
            rate = lambda ms: c.ops["int8"] / ms * 1e-9          # noqa: E731
            extra += (f" | {rate(ms_k):.1f} TOP/s, "
                      f"{100 * rate(ms_k) * 1e12 / PEAK_OPS_PER_S['int8']:.1f}% "
                      f"of the int8 peak" + (f" (library {rate(lib_ms):.1f} TOP/s)"
                                             if c.library else ""))
        print(f"phase2 {c.name} {c.what}: max_abs_err {max_err:.5g} mean_abs_err "
              f"{mean_err:.5g} int8 max diff {lsb} LSB (tol atol {c.atol} + "
              f"rtol {c.rtol}, {c.lsb} LSB; |want| mean {want_mean:.5g} max "
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


def _must_fail(name, what, bad, want, atol, rtol, lsb: int = 1):
    """A planted fault: the comparison that passes the kernel must reject
    `bad`, a wrong output of the same shape."""
    import torch
    torch.cuda.synchronize()
    try:
        _compare(name, bad, want, atol, rtol, lsb)
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
    # planted faults: a column scale or a slab's row scales read wrong (K10,
    # K11); a row scale doubled, the residual read one row off (K9)
    s1_bad, hs_bad, rs_bad = s1.clone(), hs.clone(), rs.clone()
    s1_bad[7] *= 2
    hs_bad[:, 1] *= 2
    rs_bad[1000] *= 2
    x2_off = torch.roll(x2, 1, 0)

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
             (xq, rs, wo, so, bk_, gate, x2), xq, wo,
             faults={"row 1000's scale doubled": lambda: qt._int8_gemm_postscale_cuda(
                         xq, rs_bad, wo, so, bk_, None, gate, x2),
                     "residual read one row off": lambda: qt._int8_gemm_postscale_cuda(
                         xq, rs, wo, so, bk_, None, gate, x2_off)}),
        gemm("K9", f"cross K {TEXT}x{DIM}x{DIM} + bias",
             lambda: qt._int8_gemm_postscale_cuda(cq, crs, wk, sk, bk_, None, None,
                                                  None),
             lambda: qt.int8_gemm_postscale_plain(cq, crs, wk, sk, bk_),
             (cq, crs, wk, sk, bk_), cq, wk),
        gemm("K10", f"fc1 {L}x{FFN}x{DIM} + bias, GELU -> int8, BN {BNQ}",
             lambda: qt._int8_gemm_qout_cuda(xq, rs, w1, s1, b1, "gelu_tanh"),
             lambda: qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1,
                                                       act="gelu_tanh"),
             (xq, rs, w1, s1, b1), xq, w1,
             faults={"column 7's scale doubled": lambda: qt._int8_gemm_qout_cuda(
                 xq, rs, w1, s1_bad, b1, "gelu_tanh")}, **scale_tol),
        gemm("K11", f"fc2 {L}x{DIM}x{FFN}, K slabs {BNQ}, + bias, gate, residual",
             lambda: qt._int8_gemm_blockact_cuda(hq, hs, w2, s2, b2, None, BNQ,
                                                 gate, x2),
             lambda: qt.int8_gemm_blockact_plain(hq, hs, w2, s2, b2, bk=BNQ,
                                                 gate=gate, residual=x2),
             (hq, hs, w2, s2, b2, gate, x2), hq, w2,
             faults={"slab 1's row scales doubled": lambda: qt._int8_gemm_blockact_cuda(
                 hq, hs_bad, w2, s2, b2, None, BNQ, gate, x2)}),
    ] + (_k9_edge_checks(gemm, geo) + _ffn_edge_checks(randn, gemm, geo)
         if geo == G13 else [])


def _fresh_randn(seed: int):
    """A randn(*shape, dtype, std) on the card from a generator of its own:
    checks added later draw from it, so the inputs of the checks drawn from
    phase 2's generator stay what they were."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    return randn


def _k9_edge_checks(gemm, geo: Geometry):
    """K9 off the paths' shapes, with bias, gate and residual: a ragged M
    (1,000 rows: a last tile of 104 rows), K = 192 (a multiple of 64, not of
    128: the last 128-byte K tile reads zeros past K) and N = 1,152 (9
    tiles: N / 128 odd, one block a cluster)."""
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt
    DIM = geo.dim
    randn = _fresh_randn(13)
    out = []
    for M, N, K in ((1000, DIM, DIM), (L, DIM, 192), (L, 1152, DIM)):
        xq, rs = qt.quantize_rows_int8_plain(randn(M, K))
        wq, cs = qt.quantize_int8_postscale(randn(N, K, std=K ** -0.5))
        b, res = randn(N, std=0.1), randn(M, N)
        gate = randn(N, dtype=torch.float32, std=0.5)
        out.append(gemm(
            "K9", f"{M}x{N}x{K} + bias, gate, residual",
            lambda xq=xq, rs=rs, wq=wq, cs=cs, b=b, gate=gate, res=res:
            qt._int8_gemm_postscale_cuda(xq, rs, wq, cs, b, None, gate, res),
            lambda xq=xq, rs=rs, wq=wq, cs=cs, b=b, gate=gate, res=res:
            qt.int8_gemm_postscale_plain(xq, rs, wq, cs, b, gate=gate, residual=res),
            (xq, rs, wq, cs, b, gate, res), xq, wq))
    return out


def _ffn_edge_checks(randn, gemm, geo: Geometry):
    """K10 and K11 off the paths' shapes: a ragged M (1,000 rows: a last
    K10 tile of 232 rows, a last K11 tile of 40) at the model's FFN, and
    FFN widths whose scale block / slab is 384 and 1024 (K10 clusters of 3
    and 8) at the paths' rows. fc2 reads fc1's plain output."""
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt
    DIM = geo.dim
    out = []
    for M, ffn in ((1000, geo.ffn), (L, 3456), (L, 4096)):
        bn = qt.pick_bn_div(ffn)
        x2 = randn(M, DIM)
        xq, rs = qt.quantize_rows_int8_plain(x2)
        w1, s1 = qt.quantize_int8_postscale(randn(ffn, DIM, std=DIM ** -0.5))
        w2, s2 = qt.quantize_int8_postscale(randn(DIM, ffn, std=ffn ** -0.5))
        b1, b2 = randn(ffn, std=0.1), randn(DIM, std=0.1)
        gate = randn(DIM, dtype=torch.float32, std=0.5)
        hq, hs = qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1,
                                                   act="gelu_tanh")
        out += [
            gemm("K10", f"fc1 {M}x{ffn}x{DIM}, BN {bn} (clusters of {bn // 128})",
                 lambda xq=xq, rs=rs, w1=w1, s1=s1, b1=b1: qt._int8_gemm_qout_cuda(
                     xq, rs, w1, s1, b1, "gelu_tanh"),
                 lambda xq=xq, rs=rs, w1=w1, s1=s1, b1=b1:
                 qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1, act="gelu_tanh"),
                 (xq, rs, w1, s1, b1), xq, w1,
                 atol=0.0, rtol=SCALE_RTOL),
            gemm("K11", f"fc2 {M}x{DIM}x{ffn}, K slabs {bn}, gate, residual",
                 lambda hq=hq, hs=hs, w2=w2, s2=s2, b2=b2, gate=gate, x2=x2, bn=bn:
                 qt._int8_gemm_blockact_cuda(hq, hs, w2, s2, b2, None, bn, gate, x2),
                 lambda hq=hq, hs=hs, w2=w2, s2=s2, b2=b2, gate=gate, x2=x2, bn=bn:
                 qt.int8_gemm_blockact_plain(hq, hs, w2, s2, b2, bk=bn, gate=gate,
                                             residual=x2),
                 (hq, hs, w2, s2, b2, gate, x2), hq, w2)]
    return out


def _k4_edge_checks(q, kt, vt, sdpa):
    """Phase-2 checks of K4 beyond the path's two calls (1.3B, 12 heads):
    the cross shape at batch 2; a ragged Lq of 1,000 rows over the 32,760
    keys; kv_len 500 of 512 text keys with NaN in k and v past it (held
    against the plain version on the first 500 keys); q, k and v read in
    place as the column groups of one fused (B, L, 3 x 1536) QKV buffer
    (rows 4,608 apart; the q group sharp, std 3, so the outputs are of
    order 1 and a wrong scale shows: the scale doubled must be rejected);
    and the cross shape on a sharp q (std 2, outputs of order 1), which
    must reject three planted faults: v read from k, the scale doubled, and
    the last 128-key chunk dropped (kv_len 384 against the full result).
    Its inputs come from a generator of its own, so the other checks keep
    theirs."""
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    randn = _fresh_randn(40)
    HEADS, scale = G13.heads, DH ** -0.5
    ops4 = lambda b, lq, lk: {"bf16": 4 * b * HEADS * lq * lk * DH}    # noqa: E731
    q2, kt2, vt2 = randn(2, L, HEADS, DH), randn(2, TEXT, HEADS, DH), randn(2, TEXT, HEADS, DH)
    qr = q[:, :1000]
    kn, vn = kt.clone(), vt.clone()
    kn[:, 500:], vn[:, 500:] = float("nan"), float("nan")
    qkv = randn(B, L, 3 * HEADS * DH)
    qkv[..., :HEADS * DH] *= 3
    qg, kg, vg = (qkv[..., i * HEADS * DH:(i + 1) * HEADS * DH].unflatten(-1, (HEADS, DH))
                  for i in range(3))
    qs = randn(B, L, HEADS, DH, std=2.0)
    lib = "F.scaled_dot_product_attention"
    return [
        Check("K4", f"cross {L}x{TEXT}, batch 2",
              lambda: fa._flash_cuda(q2, kt2, vt2, scale, TEXT),
              lambda: fa.flash_attention_plain(q2, kt2, vt2, scale, TEXT),
              (q2, kt2, vt2), ops4(2, L, TEXT), sdpa(q2, kt2, vt2), lib),
        Check("K4", f"ragged Lq 1000 x {L} keys",
              lambda: fa._flash_cuda(qr, q, q, scale, L),
              lambda: fa.flash_attention_plain(qr, q, q, scale, L),
              (qr, q), ops4(1, 1000, L)),
        Check("K4", f"cross kv_len 500 of {TEXT}, NaN in k and v past it",
              lambda: fa._flash_cuda(q, kn, vn, scale, 500),
              lambda: fa.flash_attention_plain(q, kt[:, :500], vt[:, :500], scale, 500),
              (q, kt[:, :500], vt[:, :500]), ops4(1, L, 500)),
        Check("K4", f"dense self {L}x{L}, q / k / v column groups of a fused QKV",
              lambda: fa._flash_cuda(qg, kg, vg, scale, L),
              lambda: fa.flash_attention_plain(qg, kg, vg, scale, L),
              (qkv,), ops4(1, L, L),
              faults={"scale doubled": lambda: fa._flash_cuda(qg, kg, vg, 2 * scale, L)}),
        Check("K4", f"cross {L}x{TEXT}, sharp q (std 2)",
              lambda: fa._flash_cuda(qs, kt, vt, scale, TEXT),
              lambda: fa.flash_attention_plain(qs, kt, vt, scale, TEXT),
              (qs, kt, vt), ops4(1, L, TEXT),
              faults={"v read from k": lambda: fa._flash_cuda(qs, kt, kt, scale, TEXT),
                      "scale doubled": lambda: fa._flash_cuda(qs, kt, vt, 2 * scale, TEXT),
                      "last 128-key chunk dropped": lambda: fa._flash_cuda(
                          qs, kt, vt, scale, TEXT - 128)}),
    ]


def _block_gemm_checks(randn, geo: Geometry = G13):
    """Phase-2 checks of K22 at a block-scale path's shapes (bf16 out, as
    the path writes it; the 1.3B: self q / k / v / o and cross q / o
    32760x1536x1536, fc1 32760x8960x1536, fc2 32760x1536x8960, text k / v
    512x1536x1536; the 14B the same at dim 5120, FFN 13824, and a ragged M
    of 1,000 rows) and, at the 1.3B, in fp32 on the square shape and a
    ragged one (1000x300x200: K and N padded), fp32 bit-equal to the plain version
    (the same fp32 terms in the same K-block order), bf16 within one step.
    The block scales span a factor of ~55, so a scale read from the wrong
    block shows; two planted faults must be rejected: ws transposed (on the
    square shape, where the shapes cannot catch it) and xs shifted by one
    M block. The square and ragged ones read xs from the end of mapped
    memory (`ops._guard`): a scale read past xs stops the card with an
    illegal address. Beside each: `torch._int_mm` (the product alone) and bf16
    `torch.matmul` of the same shape; beside the 1536- and 8960-wide ones,
    the plain-torch activation quantiser that feeds K22 on the path."""
    import torch
    from turbodiffusion_tpu_torch.ops import quant as qt
    from turbodiffusion_tpu_torch.ops._guard import guarded_copy

    def scales(r, c):
        return 1e-3 * torch.exp(4 * randn(r, c, dtype=torch.float32).sigmoid())

    def int8(*shape):
        return randn(*shape, dtype=torch.float32, std=60.0).round().clamp(
            -127, 127).to(torch.int8)

    def check(what, M, K, N, out, faults=False, quantiser=False, guard=False):
        cd = lambda n: -(-n // 128)                     # noqa: E731
        xq, wq = int8(M, K), int8(N, K)
        x = randn(M, K)
        xs, ws = scales(cd(M), cd(K)), scales(cd(N), cd(K))
        if guard:               # xs ends where mapped memory ends
            xs = guarded_copy(xs)
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

    D, F = geo.dim, geo.ffn
    bf, f32 = torch.bfloat16, torch.float32
    pre = "" if geo is G13 else "14B "
    out = [check(f"{pre}self / cross q, k, v, o", L, D, D, bf, quantiser=True),
           check(f"{pre}fc1", L, D, F, bf), check(f"{pre}fc2", L, F, D, bf, quantiser=True),
           check(f"{pre}text k / v", TEXT, D, D, bf)]
    if geo is G13:
        return out + [check("square", L, D, D, f32, faults=True, guard=True),
                      check("ragged", 1000, 200, 300, f32, guard=True)]
    return out + [check(f"{pre}ragged M", 1000, D, D, bf, guard=True)]


def _k12_one_warp_scale(x, ms, mb):
    """K12's output with each row's scale taken from the first of its warps'
    share alone (the 32-vector spans 0, 4, 8, ... of a 5120-wide row's four
    warps) and the row requantised with it: a wide row whose warps skipped
    the absmax exchange."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    q, s = fn._mln_quant_cuda(x, ms, mb, None, None, 1e-6)
    y = q.float() * s
    cols = torch.arange(x.shape[-1], device=x.device).view(-1, 256)[0::4].reshape(-1)
    s_bad = y[..., cols].abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127
    return torch.round(y / s_bad).clamp(-127, 127).to(torch.int8), s_bad


def _k12_checks(x, ms, mb, w, bias):
    """K12 as norm1 / norm2 (modulated) and norm3 (affine) on x's rows, each
    asserting its warp-per-row form; above 2048 wide (a row on several
    warps) rejecting a row's scale taken from one warp's share; `F.layer_norm`
    (bf16 out) beside it as a yardstick."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)
    n_x, D = x.numel(), x.shape[-1]
    wide = {"a row's scale from one warp's share": lambda: _k12_one_warp_scale(x, ms, mb)}
    return [
        Check("K12", f"mod -> int8 (norm1/norm2), D {D} {_k12_form(x, ms, mb, None, None)}",
              lambda: fn._mln_quant_cuda(x, ms, mb, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=True),
              (x, ms, mb), {"fp32": 11 * n_x}, **scale_tol,
              yardsticks={"F.layer_norm (bf16 out)":
                          lambda: torch.nn.functional.layer_norm(x, (D,), eps=1e-6)},
              faults=wide if D > 2048 else {}),
        Check("K12", f"affine -> int8 (norm3), D {D} {_k12_form(x, None, None, w, bias)}",
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

    def other_batch_row():
        # batch 1's first row quantised with batch 0's modulation
        q, s = fn.modulated_layer_norm(x2, e2[:, 1:2], e2[:, 0:1], eps=1e-6,
                                       quant_out=True)
        qr, sr = fn.modulated_layer_norm(x2[1:2, :1], e2[0:1, 1:2], e2[0:1, 0:1],
                                         eps=1e-6, quant_out=True)
        q[1, 0], s[1, 0] = qr[0, 0], sr[0, 0]
        return q, s

    form2 = _k12_form(x2, e2[:, 1].contiguous(), e2[:, 0].contiguous(), None, None)
    return _k12_checks(x, ms, mb, w, bias) + [
        Check("K12", f"mod -> int8 at batch 2, strided (2, 6, {DIM}) modulation {form2}",
              lambda: fn.modulated_layer_norm(x2, e2[:, 1:2], e2[:, 0:1],
                                              eps=1e-6, quant_out=True),
              lambda: fn.modulated_layer_norm_ref(x2, e2[:, 1:2], e2[:, 0:1],
                                                  eps=1e-6, quant_out=True),
              (x2, e2[:, :2]), {"fp32": 22 * n_x}, **scale_tol,
              faults={"one row's modulation from the other batch": other_batch_row}),
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
    ] + _qout_edge_checks(G13.heads, False)


def _qout_inputs(randn, heads: int, lq: int, ext: bool, batch: int = 1,
                 kv_len: int = TEXT, ld: int = 0, sharp: bool = False):
    """(q, K15's RMS inverse or None, k, v, norm weight) for K14 (ext
    False) or K17: q (batch, lq, heads x 128), a column slice of rows `ld`
    wide when ld > 0; sharp: each row one of 8 directions plus noise, and
    the 8 keys at 0, 73, ..., 511 (of 512) 12 x those directions normed, so
    that one key dominates each row by ~136 in the logits, in either half
    of the keys."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    HD = heads * DH
    w = (1 + randn(HD, dtype=torch.float32, std=0.1)).bfloat16()
    if sharp:
        d = randn(batch, 8, HD)
        x = (d[:, torch.arange(lq, device=d.device) % 8]
             + randn(batch, lq, HD, dtype=torch.float32, std=0.05)).bfloat16()
    else:
        x = randn(batch, lq, ld or HD)
    q = x[..., :HD]
    k, v = randn(batch, kv_len, heads, DH), randn(batch, kv_len, heads, DH)
    if sharp:
        keys = torch.linspace(0, kv_len - 1, 8, device=d.device).long()
        k[:, keys] = (12 * fn.rms_norm(d, w, 1e-6).float()).bfloat16().view(
            batch, 8, heads, DH)
    return q, sf.row_rms_inv_plain(q, 1e-6) if ext else None, k, v, w


def _qout_faulty(q, ri, k, v, w, fault: str):
    """What K14 / K17 would write with a planted fault, by the plain
    version's steps: "block amax", each block's G heads quantised with
    their own rows' |o| max and block 0's scales written (the cluster's
    exchange skipped); "half max", every key's P = exp(s - m) at the row
    max m of consumer 0's keys only (consumer 1's half ignored)."""
    import torch
    from turbodiffusion_tpu_torch.models.layers import rms_norm
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops.quant import quantize_rows_int8_plain
    Bq, Lq, HD = q.shape
    H, Lk = k.shape[2], k.shape[1]
    shape = fa.qout_shape(H, Lk)
    qn = (rms_norm(q, w, 1e-6) if ri is None else
          (q.float() * ri.float()).to(q.dtype) * w.to(q.dtype)).reshape(Bq, Lq, H, DH)
    if fault == "half max":
        s = torch.matmul(qn.permute(0, 2, 1, 3).float(),
                         k.permute(0, 2, 3, 1).float()) * DH ** -0.5
        m = s[..., :shape["consumer0_chunks"] * 64].amax(-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.matmul(p.bfloat16().float(), v.permute(0, 2, 1, 3).float()) / \
            p.sum(-1, keepdim=True).clamp_min(1e-20)
        return quantize_rows_int8_plain(o.permute(0, 2, 1, 3).reshape(Bq, Lq, HD))
    o = fa._flash_plain_f32(qn, k, v, DH ** -0.5, Lk).reshape(Bq, Lq, HD)
    GD = shape["heads_per_block"] * DH
    parts = [quantize_rows_int8_plain(o[..., c:c + GD]) for c in range(0, HD, GD)]
    return torch.cat([p_[0] for p_ in parts], -1), parts[0][1]


def _qout_edge_checks(heads: int, ext: bool) -> list:
    """K14 (12 heads) or K17 (40 heads, K15's RMS given) off the path's
    call, each against its plain version at K14's tolerances: a sharp q
    (one key of 512 dominates each row by ~136 in the logits, in either
    half of the keys; a running max would round P elsewhere), which must
    reject two planted faults: the scale from one block's heads only (the
    cluster's |o| max exchange skipped) and the second key half's row max
    ignored (its P overflow); a ragged Lq of 1,000 with kv_len 300 (neither
    512 nor a multiple of the 64-key chunk); batch 2 with q a column slice
    (rows 3 x or 2 x H*128 wide); kv_len 1,100, past the 512 keys the single
    pass holds (a first pass over K takes the rows' exact max). Inputs from
    a generator of their own."""
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    randn = _fresh_randn(16 + heads)
    name = "K17" if ext else "K14"
    if ext:
        kern = lambda q, ri, k, v, w: fa._cross_qout_wide_cuda(q, ri, k, v, w, DH ** -0.5)  # noqa: E731
        plain = lambda q, ri, k, v, w: fa.cross_attention_qout_wide_plain(  # noqa: E731
            q, ri, k, v, w, DH ** -0.5)
    else:
        kern = lambda q, ri, k, v, w: fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6)  # noqa: E731
        plain = lambda q, ri, k, v, w: fa.cross_attention_qout_plain(  # noqa: E731
            q, k, v, w, DH ** -0.5, 1e-6)
    wide = 2 if ext else 3
    cases = [(f"sharp q, {L}x{TEXT}", dict(lq=L, sharp=True)),
             ("ragged Lq 1000, kv_len 300", dict(lq=1000, kv_len=300)),
             (f"batch 2, q a column slice ({wide} x {heads * DH} wide), 4096 rows",
              dict(lq=4096, batch=2, ld=wide * heads * DH)),
             ("kv_len 1100 (two passes), 2048 rows", dict(lq=2048, kv_len=1100))]
    out = []
    for what, kw in cases:
        ins = _qout_inputs(randn, heads, ext=ext, **kw)
        q, ri, k, v, w = ins
        ops = {"bf16": 4 * q.shape[0] * heads * q.shape[1] * k.shape[1] * DH}
        faults = {}
        if kw.get("sharp"):
            faults = {"scale from one block's heads only (the cluster's amax skipped)":
                      lambda ins=ins: _qout_faulty(*ins, "block amax"),
                      "the second key half's row max ignored":
                      lambda ins=ins: _qout_faulty(*ins, "half max")}
        out.append(Check(name, f"{what}, {heads} heads", lambda ins=ins: kern(*ins),
                         lambda ins=ins: plain(*ins),
                         tuple(t for t in (q, ri, k, v, w) if t is not None), ops,
                         atol=0.0, rtol=K14_SCALE_RTOL, faults=faults))
    return out


def _k1_form(x, ms, mb, w, b) -> str:
    """The form K1's C entry takes for these operands (its own rule; the
    output, freshly allocated, is aligned)."""
    from turbodiffusion_tpu_torch.ops import _build
    ptr = lambda t: None if t is None else t.data_ptr()           # noqa: E731
    ok = _build.load().tdx_modulated_layer_norm_form(
        ptr(x), None, ptr(ms), ptr(mb), ptr(w), ptr(b), x.shape[-1])
    return "vector" if ok else "loop"


def _k2_form(x, w, cos, sin, heads: int) -> str:
    """The form K2's C entry takes for these inputs."""
    from turbodiffusion_tpu_torch.ops import _build
    ptr = lambda t: None if t is None else t.data_ptr()           # noqa: E731
    HD = x.shape[-1]
    ok = _build.load().tdx_rmsnorm_rope_form(ptr(x), None, ptr(w), ptr(cos), ptr(sin),
                                             x.stride(1), heads, HD // heads)
    return "vector" if ok else "loop"


def _k3_form(q, k, v, bq: int, bk: int, kv_len: int) -> str:
    """The form K3's C entry takes for these operands (its own rule; the
    output, freshly allocated, is contiguous), which the package's
    `sparse_flash_form` must name too."""
    import ctypes
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    B_, Lq, H, D = q.shape
    st = fa._strides(q, k, v) + [Lq * H * D, H * D, D]
    code = _build.load().tdx_sparse_flash_attention_form(bq, bk, kv_len,
                                                         (ctypes.c_int64 * 12)(*st))
    got = {1: "wgmma", 0: "mma"}.get(code, "refused")
    py = fa.sparse_flash_form(bq, bk, kv_len, *st)
    if got != py:
        raise AssertionError(f"K3 at {bq}/{bk}: the C entry takes {got}, "
                             f"sparse_flash_form says {py}")
    return got


def _k20_form(q, k, v, bq: int, bk: int, kv_len: int) -> str:
    """The form K20's C entry takes for these operands (the output, freshly
    allocated, is contiguous), which the package's `sparse_flash_i8qk_form`
    must name too."""
    import ctypes
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    B_, Lq, H, D = q.shape
    st = fa._strides(q, k, v) + [Lq * H * D, H * D, D]
    code = _build.load().tdx_sparse_flash_attention_i8qk_form(
        bq, bk, kv_len, k.shape[1], (ctypes.c_int64 * 12)(*st))
    got = {1: "wgmma"}.get(code, "refused")
    py = fa.sparse_flash_i8qk_form(bq, bk, kv_len, k.shape[1], *st)
    if got != py:
        raise AssertionError(f"K20 at {bq}/{bk}: the C entry takes {got}, "
                             f"sparse_flash_i8qk_form says {py}")
    return got


def _k28_form(Lp: int, Lkp: int, kv_len: int, bq: int, bk: int, name: str = "K28") -> str:
    """The form K28's (or K19's) C entry takes, which the package's
    `sparse_i8_planes_bs_form` (`sparse_i8_planes_form`) must name too."""
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    query, fn = {"K28": ("tdx_sparse_attention_i8_planes_bs_form",
                         si8.sparse_i8_planes_bs_form),
                 "K19": ("tdx_sparse_attention_i8_planes_form",
                         si8.sparse_i8_planes_form)}[name]
    code = getattr(_build.load(), query)(Lp, Lkp, kv_len, bq, bk)
    got = {1: "wgmma", 0: "mma"}.get(code, "refused")
    py = fn(Lp, Lkp, kv_len, bq, bk)
    if got != py:
        raise AssertionError(f"{name} at {bq}/{bk}: the C entry takes {got}, "
                             f"{fn.__name__} says {py}")
    return got


def _flex_sparse(q, k, v, lut, block_q: int, block_k: int):
    """K3's library yardstick: one call of `flex_attention`, compiled, with a
    BlockMask whose kv blocks are each row's LUT ids (512 x block_k blocks,
    the mask the same selection and kv_idx < Lk), on (B, L, H, D) q, k, v;
    None, with the reason printed, where it does not compile. The port
    never calls it."""
    import torch
    try:
        from torch.nn.attention.flex_attention import BlockMask, flex_attention
        Lq, Lk = q.shape[1], k.shape[1]
        nk = -(-Lk // block_k)
        sel = lut.shape[-1]
        idx = torch.zeros(*lut.shape[:3], nk, dtype=torch.int32, device=q.device)
        idx[..., :sel] = lut
        num = torch.full(lut.shape[:3], sel, dtype=torch.int32, device=q.device)
        chosen = torch.zeros(*lut.shape[:3], nk, dtype=torch.bool, device=q.device)
        chosen.scatter_(-1, lut.long(), True)

        def mask(b, h, q_idx, kv_idx):
            return chosen[b, h, q_idx // block_q, kv_idx // block_k] & (kv_idx < Lk)

        bm = BlockMask.from_kv_blocks(num, idx, BLOCK_SIZE=(block_q, block_k),
                                      mask_mod=mask, seq_lengths=(Lq, Lk))
        fx = torch.compile(flex_attention, dynamic=False)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        call = lambda: fx(qh, kh, vh, block_mask=bm)      # noqa: E731
        call()
        torch.cuda.synchronize()
        return call
    except Exception as e:           # no library time: say why
        print(f"phase2 K3 library: flex_attention does not compile here: "
              f"{type(e).__name__}: {str(e)[:300]}", flush=True)
        return None


def _k3_checks(q, k, v, lut, topk: int, heads: int, what: str = "") -> list:
    """Phase-2 checks of K3 at a path's shape (512/256, 12 of 128 K blocks),
    each asserting its form: the path's inputs (compiled `flex_attention`
    on the same LUT beside it, where it compiles); a sharp q (std 3, one or a
    few keys lead each row, outputs of order 1) rejecting three planted
    faults (the last LUT entry dropped, the scale doubled, v read from k);
    at the 1.3B also 512/64 (`sla` at --sla_block 64, the mma.sync form) on
    a LUT of the same share of 512 K blocks. The sharp q comes from a
    generator of its own."""
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    scale = DH ** -0.5
    form = _form(_k3_form(q, k, v, BQ, BK, L), "wgmma", f"K3 at {BQ}/{BK}")
    qs = _fresh_randn(170 + heads)(B, L, heads, DH, std=3.0)

    def k3(q_=q, lut_=lut, k_=k, v_=v, sc=scale, bq=BQ, bk=BK):
        return lambda: fa._sparse_flash_cuda(q_, k_, v_, lut_, bq, bk, sc, L)

    def plain(q_=q, lut_=lut, bq=BQ, bk=BK):
        return lambda: fa.sparse_flash_attention_plain(q_, k, v, lut_, bq, bk, scale, L)

    ops = lambda lut_, bq, bk: {"bf16": 4 * DH * _sparse_pairs(lut_, bq, bk, L, L)}  # noqa
    flex = _flex_sparse(q, k, v, lut, BQ, BK)
    checks = [
        Check("K3", f"{what}sparse topk {TOPK} ({topk}/128 blocks) {BQ}/{BK}, {heads} "
              f"heads {form}", k3(), plain(), (q, k, v, lut), ops(lut, BQ, BK), flex,
              "flex_attention (compiled, a BlockMask of the LUT)" if flex else ""),
        Check("K3", f"{what}sparse {BQ}/{BK}, sharp q (std 3) {form}", k3(q_=qs),
              plain(q_=qs), (qs, k, v, lut), ops(lut, BQ, BK),
              faults={"last LUT entry dropped": k3(q_=qs, lut_=lut[..., :-1].contiguous()),
                      "scale doubled": k3(q_=qs, sc=2 * scale),
                      "v read from k": k3(q_=qs, v_=k)}),
    ]
    if heads == G13.heads:
        bk64 = 64
        _, lut64, topk64 = get_block_map(q, k, TOPK, BQ, bk64)
        form64 = _form(_k3_form(q, k, v, BQ, bk64, L), "mma", f"K3 at {BQ}/{bk64}")
        checks.append(Check(
            "K3", f"sparse topk {TOPK} ({topk64}/512 blocks) {BQ}/{bk64} (`sla` at "
            f"--sla_block 64) {form64}", k3(lut_=lut64, bk=bk64), plain(lut_=lut64, bk=bk64),
            (q, k, v, lut64), ops(lut64, BQ, bk64)))
    return checks


def _k5_form(x, w, cos, sin, heads: int) -> str:
    """The form K5's C entry takes for these inputs (the outputs, freshly
    allocated, are aligned), "[vector form]" or a failure: the package's
    `head_planes_form` must name it too, and every path shape takes the
    warp-per-row kernel."""
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    ptr = lambda t: None if t is None else t.data_ptr()           # noqa: E731
    ptrs = [ptr(x), ptr(w), ptr(cos), ptr(sin), None, None, None]
    code = _build.load().tdx_head_planes_form(*ptrs, x.stride(1), heads)
    py = sf.head_planes_form(heads, x.stride(1), *ptrs)
    got = "vector" if code else "refused"
    if got != py:
        raise AssertionError(f"K5's C entry takes the {got} form, head_planes_form says {py}")
    return _form(got, "vector", f"K5 at {tuple(x.shape)}")


def _k12_form(x, ms, mb, w, b) -> str:
    """The form K12's C entry takes for these operands, which the package's
    `mln_quant_form` must name too."""
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    ptr = lambda t: None if t is None else t.data_ptr()           # noqa: E731
    ptrs = [ptr(x), None, ptr(ms), ptr(mb), ptr(w), ptr(b)]
    code = _build.load().tdx_modulated_layer_norm_quant_form(*ptrs, x.shape[-1])
    py = fn.mln_quant_form(x.shape[-1], *ptrs)
    got = "vector" if code else "loop"
    if got != py:
        raise AssertionError(f"K12's C entry takes the {got} form, mln_quant_form says {py}")
    return _form(got, "vector", f"K12 at {tuple(x.shape)}")


def _k5_rms(x, w, cosF, sinF, heads: int, pool: int, quant: bool, bf16_out: bool):
    """The RMS inverse each row took in a K5 launch with the row's own
    statistic (B, L, 1). The K5 checks feed it to the plain version and
    check it against the plain statistic apart: the plain version sums in
    another order, and one ulp of the RMS can move a bf16 step of the normed
    row, which RoPE's cancellation can turn into two int8 steps of an output
    (seen in the 14B's Q pass)."""
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    return sf._head_planes_cuda(x, w, cosF, sinF, heads, 1e-6, pool, quant, bf16_out, LP,
                                rms_out=True)["rms_inv"]


def _k5_faults(x, w, cosF, sinF, heads: int, pool: int, quant: bool, bf16_out: bool) -> dict:
    """What a check of a K5 pass must reject, each the kernel's own output
    with one thing wrong: the first tile's rows left out of the first pool
    window's means; with int8, head 0's scale taken from head 1; with bf16
    planes, the RoPE partner one vector (8 channels) off."""
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    L_ = x.shape[1]

    def run():
        return sf._head_planes_cuda(x, w, cosF, sinF, heads, 1e-6, pool, quant, bf16_out, LP)

    def tile_left_out():
        out = run()
        first = sf.head_planes_plain(x[:, :64], w, cosF, sinF, num_heads=heads, eps=1e-6,
                                     pool=64)["pooled"][:, :, 0]
        out["pooled"][:, :, 0] -= first * (64 / pool)
        return out

    def neighbour_scale():
        out = run()
        out["scale"][:, 0] = out["scale"][:, 1]
        return out

    def partner_off():
        out = run()
        # the kernel's own normed planes, rotated with partner j + 64 + 8
        y = sf._head_planes_cuda(x, w, None, None, heads, 1e-6, 0, False, True, LP)["bf16"]
        y = y[:, :, :L_].float()
        p = torch.roll(y, -(DH // 2 + 8), dims=-1)
        out["bf16"][:, :, :L_] = (y * cosF[:L_] + p * sinF[:L_]).bfloat16()
        return out

    faults = {"the first tile's rows left out of window 0's pooled means": tile_left_out}
    if quant:
        faults["head 0's int8 scale taken from head 1"] = neighbour_scale
    if bf16_out:
        faults["RoPE partner one vector off"] = partner_off
    return faults


def _form(got: str, want: str, what: str) -> str:
    if got != want:
        raise AssertionError(f"{what} takes the {got} form, not the {want} form")
    return f"[{got} form]"


def _k2_rope_faults(x, w, cosF, sinF, heads: int) -> dict:
    """What a check of K2 with RoPE must reject: the RoPE partner one vector
    (8 channels) off, the sin sign flipped, and a weight channel doubled in
    the row's last vector (the last one a lane holds)."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    B, L_, HD = x.shape
    Dh = HD // heads
    w_bad = w.clone()
    w_bad[HD - 3] *= 2

    def partner_off():
        # the kernel's own normed rows, rotated with partner j + Dh/2 + 8
        y = fn._rmsrope_cuda(x, w, None, None, 1e-6, heads).float()
        p = torch.roll(y, -(Dh // 2 + 8), dims=-1)
        return (y * cosF[None, :L_, None] + p * sinF[None, :L_, None]).to(x.dtype)

    return {"RoPE partner one vector off": partner_off,
            "sin sign flipped": lambda: fn._rmsrope_cuda(x, w, cosF, -sinF, 1e-6, heads),
            f"weight channel {HD - 3} doubled (the row's last vector)":
                lambda: fn._rmsrope_cuda(x, w_bad, cosF, sinF, 1e-6, heads)}


def _norm_form_checks(randn, x, w, bias, ms, mb, cosF, sinF, heads: int) -> list:
    """Phase-2 checks of K1 and K2's forms at x's width (1.3B: 1536, 14B:
    5120), each asserting the form its launch takes: the path shapes take
    the warp-per-row kernels. K1 bare at 5120 (F.layer_norm beside it) and
    at batch 2 with two modulations (rejecting batch 1's applied to batch 0); at
    1536 also K2 with RoPE on the fused QKV K column group (rows 3 D apart,
    as `sla` / `original` read it) and K2 in its loop form on a view 2
    bytes off alignment (RoPE, and norm only with F.rms_norm beside it)."""
    import torch
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    B_, L_, D = x.shape
    n_x = x.numel()
    pre = "" if D == G13.dim else "14B "
    F_rms_norm = getattr(torch.nn.functional, "rms_norm", None)  # torch >= 2.4
    for args in ((x, ms, mb, None, None), (x, None, None, w, bias), (x, None, None, None, None)):
        _form(_k1_form(*args), "vector", f"K1 {pre}at {L_}x{D}")
    for cos, sin in ((cosF, sinF), (None, None)):
        _form(_k2_form(x, w, cos, sin, heads), "vector", f"K2 {pre}at {L_}x{D}")
    x2 = torch.cat([x, x.flip(1)])
    ms2, mb2 = (torch.stack([t[0], randn(D, dtype=torch.float32, std=0.1)]) for t in (ms, mb))
    # (the 1.3B's bare K1 is phase 2's "plain" check)
    checks = [
        Check("K1", f"{pre}bare {L_}x{D} [vector form]",
              lambda: fn._mln_cuda(x, None, None, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, None, None, None, None, 1e-6),
              (x,), {"fp32": 6 * n_x},
              lambda: torch.nn.functional.layer_norm(x, (D,), eps=1e-6), "F.layer_norm"),
    ] if pre else []
    checks += [
        Check("K1", f"{pre}mod at batch 2, two modulations "
              f"{_form(_k1_form(x2, ms2, mb2, None, None), 'vector', 'K1 at batch 2')}",
              lambda: fn._mln_cuda(x2, ms2, mb2, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x2, ms2, mb2, None, None, 1e-6),
              (x2, ms2, mb2), {"fp32": 8 * x2.numel()},
              faults={"batch 1's modulation applied to batch 0":
                      lambda: fn._mln_cuda(x2, ms2[[1, 1]], mb2[[1, 1]], None, None, 1e-6)}),
    ]
    if pre:
        return checks
    qkv = randn(B_, L_, 3 * D)
    xg = qkv[..., D:2 * D]                              # the K column group
    flat = randn(n_x + 1)
    xu = flat[1:].view(B_, L_, D)                       # 2 bytes off alignment
    return checks + [
        Check("K2", f"rope, fused QKV K group (rows {3 * D} apart) "
              f"{_form(_k2_form(xg, w, cosF, sinF, heads), 'vector', 'K2 on the K group')}",
              lambda: fn._rmsrope_cuda(xg, w, cosF, sinF, 1e-6, heads),
              lambda: fn.rmsnorm_rope_ref(xg, w, cosF, sinF, 1e-6),
              (xg, w, cosF[:L_], sinF[:L_]), {"fp32": 10 * n_x},
              faults=_k2_rope_faults(xg, w, cosF, sinF, heads)),
        Check("K2", f"rope, unaligned view "
              f"{_form(_k2_form(xu, w, cosF, sinF, heads), 'loop', 'K2 on an unaligned view')}",
              lambda: fn._rmsrope_cuda(xu, w, cosF, sinF, 1e-6, heads),
              lambda: fn.rmsnorm_rope_ref(xu, w, cosF, sinF, 1e-6),
              (xu, w, cosF[:L_], sinF[:L_]), {"fp32": 10 * n_x}),
        Check("K2", f"norm only, unaligned view "
              f"{_form(_k2_form(xu, w, None, None, heads), 'loop', 'K2 on an unaligned view')}",
              lambda: fn._rmsrope_cuda(xu, w, None, None, 1e-6, heads),
              lambda: fn.rms_norm(xu, w, 1e-6).reshape(B_, L_, heads, D // heads),
              (xu, w), {"fp32": 4 * n_x},
              (lambda: F_rms_norm(xu, (D,), w, 1e-6)) if F_rms_norm else None,
              "F.rms_norm"),
    ]


def _wide_checks(randn, sdpa):
    """Phase-2 checks of the 14B paths' kernel forms (dim 5120, 40 heads,
    FFN 13824): K1 at 5120 (the bf16 paths' norms); K2 at H*Dh 5120 (norm
    only, the cross q; RoPE, the self q /
    k of `sla` and `original`), with planted faults a kernel that stopped at
    4096 would give, and once above 5120 (48 x 128);
    K4 (cross 32,760 x 512, dense self 32,760^2 and, at 720p, 75,600^2) and
    K3 (512/256, 12 of 128 K blocks) at 40 heads; K15 on a projection's rows; K5's three passes of
    the fused path at 40 heads, Q and K taking the row's RMS themselves
    (and the Q pass once reading K15's, the external-RMS mode); K6 and K7 at 40
    heads on those planes (12 of 128 K blocks); K16 over K7-shaped planes
    (B, 40, 32,768, 128); K17 (q-norm with K15's RMS, cross attention over
    512 text keys, int8 O feed); K12, K8-K11 and K22 at the 14B widths. No
    PyTorch call computes K15-K17: SDPA of the cross shape is timed beside
    K17."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import fused_norm as fn
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    DIM, HEADS = G14.dim, G14.heads
    x = randn(B, L, DIM)
    xk, xv = randn(B, L, DIM), randn(B, L, DIM)
    ms, mb = randn(B, DIM, dtype=torch.float32, std=0.1), \
        randn(B, DIM, dtype=torch.float32, std=0.1)
    w = (1 + randn(DIM, dtype=torch.float32, std=0.1)).bfloat16()
    bias = randn(DIM, std=0.1)
    kt, vt = randn(B, TEXT, HEADS, DH), randn(B, TEXT, HEADS, DH)
    cosF, sinF = fn.rope_cos_sin_full(rope_freqs_3d(21, 30, 52, DH, device=x.device))
    ri_q = sf.row_rms_inv_plain(x, 1e-6)
    rms_q = _k5_rms(x, w, cosF, sinF, HEADS, BQ, True, False)
    rms_k = _k5_rms(xk, w, cosF, sinF, HEADS, BK, False, True)
    hp = dict(num_heads=HEADS, eps=1e-6, pad_to=LP)
    q_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BQ, quant=True,
                  bf16_out=False)
    k_form = dict(weight=w, cos_full=cosF, sin_full=sinF, pool=BK)
    Qp = sf.head_planes_plain(x, **q_form, **hp)
    Kp = sf.head_planes_plain(xk, **k_form, **hp)
    Vp = sf.head_planes_plain(xv, **hp)
    lut8, sel, k_mean = sf.block_map_from_pooled(Qp["pooled"], Kp["pooled"],
                                                 L, BK, TOPK)
    vi, vcs = si8.quantize_v_per_channel(Vp["bf16"], L)
    kp, vtp, ksb, kv, ksum = sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L,
                                                        linear_kv=True)
    i8_args = (Qp["i8"], Qp["scale"], kp, vtp, ksb, vcs, lut8)
    pairs7 = _sparse_pairs(lut8, BQ, BK, L, L)
    # the linear branch at 40 heads, as phase 2 builds it at 12
    rn = _fresh_randn(14)
    proj_w = rn(DH, DH, dtype=torch.float32, std=0.3 / math.sqrt(DH))
    lin = dict(lin_kvw=torch.matmul(kv * vcs, proj_w.t()),
               lin_ks_bias=torch.cat([ksum, rn(B, HEADS, 1, DH, dtype=torch.float32,
                                               std=0.1)], dim=2))
    planes = _with_half_integer_rows(randn(B, HEADS, LP, DH, std=2.0))
    qn = fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH)
    scale = DH ** -0.5
    scale_tol = dict(atol=0.0, rtol=SCALE_RTOL)
    n_x = x.numel()
    F_rms_norm = getattr(torch.nn.functional, "rms_norm", None)  # torch >= 2.4
    q, k, v = randn(B, L, HEADS, DH), randn(B, L, HEADS, DH), randn(B, L, HEADS, DH)
    _, lut, topk = get_block_map(q, k, TOPK, BQ, BK)
    # K2's planted faults past channel 4096: what a kernel that stopped there
    # would leave in an output prefilled with NaN, and one weight channel
    # there doubled (a kernel that never read it would pass that)
    w_bad = w.clone()
    w_bad[4100] *= 2

    def past_4096_nan(out):
        out.view(B, L, DIM)[..., 4096:] = float("nan")
        return out

    def k2_faults(cos_, sin_):
        return {"channels past 4096 left NaN": lambda: past_4096_nan(
                    fn._rmsrope_cuda(x, w, cos_, sin_, 1e-6, HEADS)),
                "weight channel 4100 doubled": lambda: fn._rmsrope_cuda(
                    x, w_bad, cos_, sin_, 1e-6, HEADS)}

    # 720p, drawn apart from the rest; q sharp (std 3: outputs of order 1
    # over 75,600 keys, so a subtle fault exceeds the tolerance)
    rn7 = _fresh_randn(41)
    q7 = rn7(B, L720, HEADS, DH, std=3.0)
    k7, v7 = rn7(B, L720, HEADS, DH), rn7(B, L720, HEADS, DH)
    WH = 48                                       # 6144 wide: above the 14B
    x6 = randn(B, L, WH * DH)
    w6 = (1 + randn(WH * DH, dtype=torch.float32, std=0.1)).bfloat16()
    ops4 = lambda lk: {"bf16": 4 * B * HEADS * L * lk * DH}      # noqa: E731
    return [
        # the bf16 14B's K1: norm3 (affine, as F.layer_norm computes it)
        # first, then norm1 / norm2 (modulated)
        Check("K1", f"14B affine (norm3) {L}x{DIM}",
              lambda: fn._mln_cuda(x, None, None, w, bias, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, None, None, w, bias, 1e-6),
              (x, w, bias), {"fp32": 8 * n_x},
              lambda: torch.nn.functional.layer_norm(x, (DIM,), w, bias, 1e-6),
              "F.layer_norm"),
        Check("K1", f"14B mod (norm1/norm2) {L}x{DIM}",
              lambda: fn._mln_cuda(x, ms, mb, None, None, 1e-6),
              lambda: fn.modulated_layer_norm_ref(x, ms, mb, None, None, 1e-6),
              (x, ms, mb), {"fp32": 8 * n_x}),
        Check("K2", f"14B norm only (cross q) {L}x{DIM}",
              lambda: fn._rmsrope_cuda(x, w, None, None, 1e-6, HEADS),
              lambda: fn.rms_norm(x, w, 1e-6).reshape(B, L, HEADS, DH),
              (x, w), {"fp32": 4 * n_x},
              (lambda: F_rms_norm(x, (DIM,), w, 1e-6)) if F_rms_norm else None,
              "F.rms_norm", faults=k2_faults(None, None)),
        Check("K2", f"14B rope (self q/k) {L}x{DIM}",
              lambda: fn._rmsrope_cuda(x, w, cosF, sinF, 1e-6, HEADS),
              lambda: fn.rmsnorm_rope_ref(x, w, cosF, sinF, 1e-6),
              (x, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x},
              faults={**k2_faults(cosF, sinF),
                      **_k2_rope_faults(x, w, cosF, sinF, HEADS)}),
        Check("K2", f"rope {L}x{WH * DH} ({WH}x{DH}, above 5120) "
              f"{_form(_k2_form(x6, w6, cosF, sinF, WH), 'vector', 'K2 at 6144')}",
              lambda: fn._rmsrope_cuda(x6, w6, cosF, sinF, 1e-6, WH),
              lambda: fn.rmsnorm_rope_ref(x6, w6, cosF, sinF, 1e-6),
              (x6, w6, cosF[:L], sinF[:L]), {"fp32": 10 * x6.numel()}),
    ] + _k3_checks(q, k, v, lut, topk, HEADS, "14B ") + [
        Check("K4", f"14B cross {L}x{TEXT}, {HEADS} heads",
              lambda: fa._flash_cuda(q, kt, vt, scale, TEXT),
              lambda: fa.flash_attention_plain(q, kt, vt, scale, TEXT),
              (q, kt, vt), ops4(TEXT), sdpa(q, kt, vt),
              "F.scaled_dot_product_attention"),
        Check("K4", f"14B dense self {L}x{L}, {HEADS} heads",
              lambda: fa._flash_cuda(q, k, v, scale, L),
              lambda: fa.flash_attention_plain(q, k, v, scale, L),
              (q, k, v), ops4(L), sdpa(q, k, v),
              "F.scaled_dot_product_attention"),
        Check("K4", f"14B dense self 720p {L720}x{L720}, {HEADS} heads",
              lambda: fa._flash_cuda(q7, k7, v7, scale, L720),
              lambda: fa.flash_attention_plain(q7, k7, v7, scale, L720),
              (q7, k7, v7), {"bf16": 4 * B * HEADS * L720 * L720 * DH}, sdpa(q7, k7, v7),
              "F.scaled_dot_product_attention"),
        Check("K15", f"row RMS inverse {L}x{DIM}",
              lambda: sf._row_rms_inv_cuda(x, 1e-6, None, 0),
              lambda: sf.row_rms_inv_plain(x, 1e-6), (x,), {"fp32": 2 * n_x},
              **scale_tol),
        Check("K5", f"14B Q (the row's RMS, rope, int8, pool {BQ}), {HEADS} heads "
              f"{_k5_form(x, w, cosF, sinF, HEADS)}",
              lambda: sf._head_planes_cuda(x, w, cosF, sinF, HEADS, 1e-6, BQ,
                                           True, False, LP),
              lambda: sf.head_planes_plain(x, **q_form, **hp, rms_inv=rms_q),
              (x, w, cosF[:L], sinF[:L]), {"fp32": 12 * n_x}, atol=K5_Q_ATOL,
              faults=_k5_faults(x, w, cosF, sinF, HEADS, BQ, True, False)),
        Check("K5", f"14B K (the row's RMS, rope, bf16, pool {BK}), {HEADS} heads "
              f"{_k5_form(xk, w, cosF, sinF, HEADS)}",
              lambda: sf._head_planes_cuda(xk, w, cosF, sinF, HEADS, 1e-6, BK,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xk, **k_form, **hp, rms_inv=rms_k),
              (xk, w, cosF[:L], sinF[:L]), {"fp32": 10 * n_x},
              faults=_k5_faults(xk, w, cosF, sinF, HEADS, BK, False, True)),
        Check("K5", f"14B the Q rows' RMS inverse the kernel took (four warps a row)",
              lambda: _k5_rms(x, w, cosF, sinF, HEADS, BQ, True, False),
              lambda: sf.row_rms_inv_plain(x, 1e-6), (x, w, cosF[:L], sinF[:L]),
              {"fp32": 12 * n_x}, atol=0.0, rtol=SCALE_RTOL),
        Check("K5", f"14B V (bf16 fold), {HEADS} heads {_k5_form(xv, None, None, None, HEADS)}",
              lambda: sf._head_planes_cuda(xv, None, None, None, HEADS, 1e-6, 0,
                                           False, True, LP),
              lambda: sf.head_planes_plain(xv, **hp), (xv,), {}),
        Check("K5", f"14B Q with K15's RMS (the external-RMS mode), {HEADS} heads",
              lambda: sf._head_planes_cuda(x, w, cosF, sinF, HEADS, 1e-6, BQ,
                                           True, False, LP, ri_q),
              lambda: sf.head_planes_plain(x, **q_form, **hp, rms_inv=ri_q),
              (x, w, ri_q, cosF[:L], sinF[:L]), {"fp32": 12 * n_x}, atol=K5_Q_ATOL),
        Check("K6", f"14B pack K/V {BK}-row blocks, {HEADS} heads",
              lambda: sf._subquant_pack_kvt_cuda(Kp["bf16"], k_mean, vi, BK, L, False),
              lambda: sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L),
              (Kp["bf16"], k_mean, vi), {"fp32": 4 * n_x}),
    ] + _k6_linear_checks(Kp["bf16"], k_mean, vi, HEADS) + [
        Check("K16", f"planes {HEADS}x{LP}x{DH} -> {L}x{DIM} int8, rows on "
              f"half-integers, bit for bit",
              lambda: sf._unfold_quant_wide_cuda(planes, L),
              lambda: sf.unfold_quant_wide_plain(planes, L),
              (planes[:, :, :L],), {"fp32": 3 * n_x}, atol=0.0, rtol=0.0, lsb=0,
              faults=_k16_faults(planes, L)),
        Check("K7", f"14B int8 sparse ({sel}/{LP // BK} blocks) {BQ}/{BK}, "
              f"{HEADS} heads",
              lambda: si8._sparse_i8_vt_cuda(*i8_args, scale, BQ, BK, L, None, None),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, block_q=BQ,
                                                       block_k=BK, kv_len=L),
              i8_args, {"int8": 2 * DH * pairs7, "bf16": 2 * DH * pairs7},
              faults=_k7_faults(i8_args, scale)),
        Check("K7", f"14B int8 sparse + linear epilogue, {HEADS} heads",
              lambda: si8._sparse_i8_vt_cuda(*i8_args, scale, BQ, BK, L,
                                             lin["lin_kvw"], lin["lin_ks_bias"]),
              lambda: si8.sparse_attention_i8_vt_plain(*i8_args, block_q=BQ,
                                                       block_k=BK, kv_len=L, **lin),
              i8_args + tuple(lin.values()),
              {"int8": 2 * DH * pairs7, "bf16": 2 * DH * pairs7}),
        Check("K17", f"q-norm (K15's RMS) + cross {L}x{TEXT} -> int8, {HEADS} heads",
              lambda: fa._cross_qout_wide_cuda(x, ri_q, kt, vt, w, scale),
              lambda: fa.cross_attention_qout_wide_plain(x, ri_q, kt, vt, w, scale),
              (x, w, ri_q, kt, vt), {"bf16": 4 * B * HEADS * L * TEXT * DH},
              atol=0.0, rtol=K14_SCALE_RTOL,
              yardsticks={"SDPA of the cross shape (attention only)":
                          sdpa(qn, kt, vt)}),
    ] + (_qout_edge_checks(HEADS, True)
         + _norm_form_checks(randn, x, w, bias, ms, mb, cosF, sinF, HEADS)
         + _k12_checks(x, ms, mb, w, bias) + _w8a8_checks(randn, x, G14)
         + _block_gemm_checks(_fresh_randn(42), G14))


def _kvt_partial_bytes(B: int, H: int, Lp: int, block_k: int) -> int:
    """Bytes K6's design moves besides its inputs and outputs with the
    linear branch: each run's partial kv / ksum sums of a head, written
    once and read once by the reduce."""
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    grid = sf._kvt_grid_on_card(0, B, H, Lp, block_k, True)
    n = sum(len(p) for p in sf.kvt_partials(B, H, Lp // block_k, grid))
    return 2 * n * 4 * sf._KVT_SLOT


def _k6_kv_exact_check(k_planes, k_mean, vi, model: str):
    """K6's kv against the float64 sums at rtol 1e-4 / atol 1e-4, the card
    tests' tolerance (the fp32 plain version, whose sums run in another
    order, is held to the file's), rejecting kv from phi's fp16 hi half
    only (a kernel that dropped the lo product) and phi split into bf16 hi
    + lo (~2^-17 of phi), each with its products summed exactly."""
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    Bk, H, Lp, D = k_planes.shape
    valid = (torch.arange(Lp, device=k_planes.device) < L)[:, None]

    def kv_of(split):
        """float64 phi^T v over the rows < L, phi as `split` leaves it."""
        phi = torch.where(valid, torch.softmax(k_planes.double(), -1), 0.0)
        return torch.matmul(split(phi).transpose(-1, -2), vi.double())

    def hi_only(phi):
        return (phi.float() * 256).half().double() / 256

    def bf16_split(phi):
        hi = phi.bfloat16().double()
        return hi + (phi - hi).bfloat16().double()

    return Check("K6", f"{model}linear kv, {H} heads, against float64 sums",
                 lambda: sf._subquant_pack_kvt_cuda(k_planes, k_mean, vi, BK, L, True)[3],
                 lambda: kv_of(lambda phi: phi), (k_planes, k_mean, vi),
                 {"fp32": 4 * k_planes.numel(), "bf16": 2 * 2 * Bk * H * L * D * D},
                 atol=1e-4, rtol=1e-4, extra_bytes=_kvt_partial_bytes(Bk, H, Lp, BK),
                 faults={"kv from phi's fp16 hi half only": lambda: kv_of(hi_only),
                         "phi split into bf16 hi + lo": lambda: kv_of(bf16_split)})


def _k6_linear_checks(k_planes, k_mean, vi, heads: int):
    """K6 with the linear branch at 40 heads (the 14B W8A8 path with a
    trained proj_l): the whole output at the file's tolerance, rejecting one
    run's partial left out of a head's kv; ksum alone at atol 5e-4 (the
    kernel's fp32 sums and the plain version's run in other orders),
    rejecting a row past kv_len let into phi and ksum summed from phi's
    fp16 hi half only (a kernel whose ksum rode on the products' hi
    operand); and kv against float64 sums (`_k6_kv_exact_check`)."""
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    Bk, H, Lp, D = k_planes.shape
    nK = Lp // BK

    def kern():
        return sf._subquant_pack_kvt_cuda(k_planes, k_mean, vi, BK, L, True)

    def plain():
        return sf.subquant_pack_kvt_plain(k_planes, k_mean, vi, BK, L, linear_kv=True)

    def rows_kv(r0, r1, bh):
        """phi^T v and sum phi of head bh's rows [r0, r1), float64 -> fp32."""
        b, h = divmod(bh, H)
        pk = torch.softmax(k_planes[b, h, r0:r1].double(), -1)
        return (pk.t() @ vi[b, h, r0:r1].double()).float(), pk.sum(0).float()

    def run_left_out():
        grid = sf._kvt_grid_on_card(0, Bk, H, Lp, BK, True)
        a, e = sf.kvt_runs(Bk * H * nK, grid)[1]      # block 1's run, within head 0
        out = list(kern())
        kv_r, _ = rows_kv(a * BK, min(e, nK) * BK, 0)
        out[3] = out[3].clone()
        out[3][0, 0] -= kv_r
        return tuple(out)

    def row_past_kv_len():
        ksum = kern()[4].clone()
        for bh in range(Bk * H):
            b, h = divmod(bh, H)
            ksum[b, h, 0] += rows_kv(L, L + 1, bh)[1]
        return ksum

    def hi_half_only():
        valid = (torch.arange(Lp, device=k_planes.device) < L)[:, None]
        phi = torch.where(valid, torch.softmax(k_planes.float(), -1), 0.0)
        return ((phi * 256).half().float() / 256).sum(2, keepdim=True)

    ops = {"fp32": 4 * k_planes.numel(), "bf16": 2 * 2 * Bk * H * L * D * D}
    return [
        Check("K6", f"14B pack + linear kv sums, {heads} heads", kern, plain,
              (k_planes, k_mean, vi), ops, extra_bytes=_kvt_partial_bytes(Bk, H, Lp, BK),
              faults={"one run's partial left out": run_left_out}),
        Check("K6", f"14B linear ksum, {heads} heads (atol 5e-4)", lambda: kern()[4],
              lambda: plain()[4], (k_planes, k_mean, vi), ops, atol=5e-4, rtol=0.0,
              extra_bytes=_kvt_partial_bytes(Bk, H, Lp, BK),
              faults={"a row past kv_len let into phi": row_past_kv_len,
                      "ksum from phi's fp16 hi half only": hi_half_only}),
        _k6_kv_exact_check(k_planes, k_mean, vi, "14B "),
    ]


def _with_half_integer_rows(planes):
    """K16's planes with their first 8 token rows on half-integers: row i
    has amax 127 * 2^-i (so scale = 2^-i exactly, 127 * fl(1/127) being 1)
    and its other values (k + 1/2) 2^-i, k in [-126, 126]: y / scale lands on
    ties, which round half to even."""
    import torch
    Bp, H, Lp, D = planes.shape
    g = torch.Generator(device=planes.device).manual_seed(16)
    rows = planes.transpose(1, 2).reshape(Bp, Lp, H * D)
    for i in range(8):
        k = torch.randint(-126, 126, (H * D,), generator=g, device=planes.device)
        vals = (k.float() + 0.5) * 2.0 ** -i
        vals[0] = 127.0 * 2.0 ** -i
        rows[:, i] = vals.to(planes.dtype)
    return rows.reshape(Bp, Lp, H, D).transpose(1, 2).contiguous()


def _k16_faults(planes, L: int) -> dict:
    """K16's planted faults (each a wrong (int8, scales) pair): row 3's scale
    taken from row 4 and its values quantised with it; the ties of the
    half-integer rows rounded away from zero (half away from even)."""
    import torch
    from turbodiffusion_tpu_torch.ops import sla_fused as sf

    def neighbour_scale():
        q, s = sf._unfold_quant_wide_cuda(planes, L)
        x = sf.unfold_planes(planes, L).float()
        s = s.clone()
        s[:, 3] = s[:, 4]
        q = q.clone()
        q[:, 3] = torch.round(x[:, 3] / s[:, 3]).clamp(-127, 127).to(torch.int8)
        return q, s

    def away_from_even():
        q, s = sf._unfold_quant_wide_cuda(planes, L)
        y = sf.unfold_planes(planes, L).float() / s
        tie = (y - y.floor()) == 0.5
        away = torch.sign(y) * torch.floor(y.abs() + 0.5)
        return torch.where(tie, away, q.float()).clamp(-127, 127).to(torch.int8), s

    return {"one row's scale taken from its neighbour": neighbour_scale,
            "a half-integer rounded away from even": away_from_even}


def _k21_form(q, k, v, kv_len: int, bhld: bool = False) -> str:
    """The form K21's launch takes on these views (out laid out as q)."""
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    if bhld:
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    views = (q, k, v, q)
    return la.linear_form(q.shape[0], q.shape[1], q.shape[2], kv_len,
                          [t.data_ptr() for t in views],
                          [t.stride(i) for t in views for i in range(3)])


def k21_f64_inputs(case: str):
    """The inputs of K21's float64 checks, from a generator of their own
    (`tools/time_k21.py --smoke` draws them too): (q, k, v, proj_l weight,
    bias, layout). `planes-12-beyond`: (1, 12, 32,768, 128) planes with
    32,760 live rows (NaN past them) and bf16 V past fp16's range (rows 3,
    19, ... at 2^17 (1 + |N(0, 1)|), rows 7, 23, ... at 2^-20 N(0, 1));
    `bhld-40-int8`: (1, 32,760, 40, 128) views with V of uniform int8
    values (|kv| ~ 100, where plain fp32 sums drift)."""
    import torch
    randn = _fresh_randn(2100 if case.startswith("planes") else 2140)
    heads = int(case.split("-")[1])
    if case.startswith("planes"):
        shape, rows = (B, heads, LP, DH), 2
    else:
        shape, rows = (B, L, heads, DH), 1
    q, k = randn(*shape, std=2.0), randn(*shape, std=2.0)
    if case.endswith("beyond"):
        v = randn(*shape, dtype=torch.float32)
        big = v.narrow(rows, 3, shape[rows] - 3).unfold(rows, 1, 16)
        big.copy_(2.0 ** 17 * (1 + big.abs()))
        v.narrow(rows, 7, shape[rows] - 7).unfold(rows, 1, 16).mul_(2.0 ** -20)
        v = v.bfloat16()
    else:
        v = (randn(*shape, dtype=torch.float32) * 50).round().clamp(-127, 127).bfloat16()
    if rows == 2:
        k[:, :, L:], v[:, :, L:] = float("nan"), float("nan")
    w = randn(DH, DH, dtype=torch.float32, std=DH ** -0.5)
    b = randn(DH, dtype=torch.float32, std=0.01)
    return q, k, v, w, b, "planes" if rows == 2 else "bhld"


def k21_f64(q, k, v, w, b, layout: str, phi_of=None, v_of=None):
    """(kv, ksum, o) of the branch in float64 over the live rows L, as
    (B, H, ...) tensors; phi_of / v_of alter phi (float64) or v (a planted
    fault)."""
    import torch
    if layout == "bhld":
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k, v = k[:, :, :L], v[:, :, :L]
    pk = torch.softmax(k.double(), -1)
    pk = phi_of(pk) if phi_of else pk
    vd = v_of(v).double() if v_of else v.double()
    kv = torch.matmul(pk.transpose(-1, -2), vd)
    ksum = pk.sum(2, keepdim=True)
    pq = torch.softmax(q[:, :, :L].double(), -1)
    o = (torch.matmul(pq, torch.matmul(kv, w.double().t()))
         / (1e-5 + (pq * ksum).sum(-1, keepdim=True)) + b.double())
    return kv, ksum, o


def k21_output(la, q, k, v, w, b, layout: str):
    """K21's output over the live rows as (B, H, L, 128), launched as the
    path launches it (`la` the port's linear_attention module)."""
    if layout == "planes":
        return la.linear_projected_planes(q, k, v, w, b, L)[:, :, :L]
    return la.linear_attention_projected(q, k, v, w, b).transpose(1, 2)


def _k21_f64_checks():
    """K21 against float64 (`k21_f64_inputs`): its kv / ksum at rtol / atol
    1e-4 of the float64 sums at 12 heads (planes, V past fp16's range:
    rejecting V taken through fp16, and a 64-row chunk left out) and at 40
    (views, int8-valued V: rejecting phi split into two bf16 parts, as
    round-to-nearest hi + lo, and the chunk left out); and a tail holding its
    output's mean |o - float64| to at most 1.1x the earlier fp32 kernel's
    on the same draws (`K21_PARENT_MEAN_ERR`)."""
    import torch
    from turbodiffusion_tpu_torch.ops import linear_attention as la
    checks, means = [], []
    for case in K21_PARENT_MEAN_ERR:
        q, k, v, w, b, layout = k21_f64_inputs(case)
        H = q.shape[1] if layout == "planes" else q.shape[2]
        qv, kv_, vv = ((q, k, v) if layout == "planes"
                       else (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
        kv64, ks64, o64 = k21_f64(q, k, v, w, b, layout)

        def two_bf16(pk):
            hi = pk.float().bfloat16().double()
            return hi + (pk.float() - hi.float()).bfloat16().double()

        def chunk_out(kv_=kv_, vv=vv, kv64=kv64, ks64=ks64):
            pk = torch.softmax(kv_[:, :, 64:128].double(), -1)
            kv = kv64.clone()
            kv[:, 0] -= torch.matmul(pk[:, 0].transpose(-1, -2), vv[:, 0, 64:128].double())
            return kv, ks64

        faults = {"a 64-row chunk of head 0 left out": chunk_out}
        if case.endswith("beyond"):
            faults["V taken through fp16"] = (
                lambda a=(q, k, v, w, b, layout): k21_f64(*a, v_of=lambda t: t.half())[:2])
        else:
            faults["phi split into two bf16 parts"] = (
                lambda a=(q, k, v, w, b, layout): k21_f64(*a, phi_of=two_bf16)[:2])
        checks.append(Check(
            "K21", f"kv / ksum against float64 sums, {case} "
            f"{_form(_k21_form(q, k, v, L, bhld=layout == 'bhld'), 'wgmma', f'K21 {case}')}",
            lambda kv_=kv_, vv=vv: la._linear_kv_sums(kv_, vv, L), lambda a=(kv64, ks64): a,
            (kv_[:, :, :L], vv[:, :, :L]), {"bf16": 3 * 2 * B * H * L * DH * DH},
            atol=1e-4, rtol=1e-4, faults=faults))

        def mean_tail(case=case, args=(q, k, v, w, b, layout), o64=o64):
            got = float((k21_output(la, *args).double() - o64).abs().mean())
            parent = K21_PARENT_MEAN_ERR[case]
            if got > 1.1 * parent:
                raise AssertionError(f"K21 {case}: mean |o - float64| {got:.6g} against "
                                     f"1.1x the earlier fp32 kernel's {parent}")
            print(f"phase2 K21 {case} mean |o - float64| {got:.6g} ({got / parent:.4f}x "
                  f"the earlier fp32 kernel's {parent:.6g})", flush=True)
        means.append(mean_tail)
    return checks, lambda: [m() for m in means]


def _mode_checks(randn, Qp, Kp, k_mean, xv, lut8, q, k, v):
    """Phase-2 checks of K18-K21 at the 1.3B 480p shapes, and their
    poisoned-tail checks (returned to run after the timed checks): K18 and
    K19 on the fused operands at v_quant="row" (V from K5's per-row int8
    pass), K20 at blocks 64/64 (int(0.1 * 512) = 51 K blocks a Q block) on
    smooth-k'd bf16 q / k / v, with K3 on the same LUT beside it; K21 over
    the planes (the row path's form) and over (B, L, H, D) (the sla path's).
    K19 and K20 each assert the form their launch takes (the wgmma
    kernels); their poisoned tails: K19's K|V rows past kv_len 127 with NaN
    K and V scales, K20's k and v rows past a kv_len of 30,000 NaN.
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

    # K21: three bf16 products a row in each pass (kv over the live rows,
    # apply over every q row), on the tensor cores
    lin_ops = {"bf16": 3 * 2 * B * HEADS * (L + LP) * DH * DH}
    checks = [
        Check("K18", f"pack K|V per row {HEADS}x{LP}x{DH}",
              lambda: sf._subquant_pack_kv_cuda(Kp["bf16"], k_mean, Vr["i8"]),
              lambda: sf.subquant_pack_kv_plain(Kp["bf16"], k_mean, Vr["i8"]),
              (Kp["bf16"], k_mean, Vr["i8"]), {"fp32": 4 * Kp["bf16"].numel()},
              atol=0.0, rtol=SCALE_RTOL),
        Check("K19", f"int8 sparse per-row scales ({lut8.shape[-1]}/{LP // BK} "
              f"blocks) {BQ}/{BK} "
              f"{_form(_k28_form(LP, LP, L, BQ, BK, 'K19'), 'wgmma', f'K19 at {BQ}/{BK}')}",
              lambda: i8_planes(lut8),
              lambda: si8.sparse_attention_i8_planes_plain(
                  *planes_args, block_q=BQ, block_k=BK, kv_len=L),
              planes_args, {"int8": 2 * DH * pairs19, "bf16": 2 * DH * pairs19},
              **sharp, faults={"last LUT entry dropped": lambda: i8_planes(lut8[..., :-1])}),
        Check("K20", f"int8-QK sparse gather ({sel64}/{LP // bk64} blocks) "
              f"{bk64}/{bk64} "
              f"{_form(_k20_form(q, ks_, v, bk64, bk64, L), 'wgmma', f'K20 at {bk64}/{bk64}')}",
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
        Check("K21", f"linear branch over planes {HEADS}x{LP}x{DH} "
              f"{_form(_k21_form(qp, kp, vp, L), 'wgmma', 'K21 over planes')}",
              k21_planes,
              lambda: la.linear_projected_planes_plain(qp, kp, vp, w21, pb, L),
              (qp, kp[:, :, :L], vp[:, :, :L], w21, pb), lin_ops, **sharp,
              faults={"proj_l weight zeroed (bias alone)":
                      lambda: k21_planes(w_=torch.zeros_like(w21)),
                      "v read from k": lambda: k21_planes(v_=kp),
                      "q doubled": lambda: k21_planes(q_=qp * 2)}),
        Check("K21", f"linear branch over (B, L, H, D) {L}x{HEADS}x{DH} "
              f"{_form(_k21_form(q21, k21, v21, L, bhld=True), 'wgmma', 'K21 over (B, L, H, D)')}",
              lambda: la.linear_attention_projected(q21, k21, v21, w21, pb),
              lambda: la.linear_attention_projected_plain(q21, k21, v21, w21, pb),
              (q21, k21, v21, w21, pb), {"bf16": 3 * 4 * B * HEADS * L * DH * DH},
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

    def k20_tail():
        """K20 on the card: k and v rows past kv_len set to NaN (the last
        2,760 of 32,760 keys, kv_len 30,000) change no output: the first
        launch quantises only the rows before kv_len, the V map ends there
        and a key past it gets its score by selection."""
        kv20 = 30000
        clean = fa._sparse_flash_i8qk_cuda(q, ks_, v, lut64, bk64, bk64, scale, kv20)
        pk, pv = ks_.clone(), v.clone()
        pk[:, kv20:], pv[:, kv20:] = float("nan"), float("nan")
        poisoned = fa._sparse_flash_i8qk_cuda(q, pk, pv, lut64, bk64, bk64, scale, kv20)
        torch.cuda.synchronize()
        if not (torch.equal(clean, poisoned) and bool(clean.float().isfinite().all())):
            raise AssertionError("K20: a poisoned tail changed the output")
        print(f"phase2 K20 poisoned tail (k, v rows {kv20}..{L - 1} NaN, kv_len "
              f"{kv20}): output unchanged, finite", flush=True)

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

    return checks, (k19_tail, k20_tail, k21_tail)


def _last_checks(randn, xq, w, cosF, sinF, Kp, k_mean, Vp, k, v, sdpa):
    """Phase-2 checks of K27-K30 at the 1.3B 480p shapes (12 heads):
    K27 on the fused path's K planes with rows past L of 1e4, then NaN
    (live rows within 1 LSB, scales bit-equal; planted faults: the
    statistic taken over the rows past L, the scales shifted by one
    block); K28 at 512/256 on the topk 0.3 LUT (38 of 128 K blocks) from a
    q of std ~3 (an RMSNorm weight of 3x), K27's operands, atol SHARP_ATOL + rtol 2e-2 as K19 (planted
    faults: a LUT entry dropped, the block-scale table shifted by one block,
    vch left out; K7 on the same LUT and operands in its VT layout timed
    beside it); K29 on K planes with a per-channel offset (so that smooth-k
    matters; planted fault: mu left out); K30 on the dense self shape
    32,760 x 32,760 with q of std 3 and smooth-k'd k (planted faults: one
    K row's scale doubled, the row that query 0 leans on most; the kv_len
    mask 64 keys short; SDPA of the shape and K4 with bf16 QK on the same
    tensors timed beside it).
    Returns (checks, a function of the further checks: K28 with the rows
    past L of K|V poisoned to +127 leaves live rows bit-equal, two runs of
    each kernel bit-equal)."""
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    HEADS = G13.heads
    scale = DH ** -0.5
    hp = dict(num_heads=HEADS, eps=1e-6, pad_to=LP)
    Q3 = sf.head_planes_plain(xq, 3 * w, cosF, sinF, pool=BQ, quant=True,
                              bf16_out=False, **hp)
    lut, sel, _ = sf.block_map_from_pooled(Q3["pooled"], Kp["pooled"], L, BK,
                                           TOPK_BS)
    vi, vcs = si8.quantize_v_per_channel(Vp["bf16"], L)
    # rows past L: 1e4 (which would win any block statistic that took
    # them; CUDA's fmaxf passes over NaN, so NaN alone could not show it),
    # then NaN
    kn = Kp["bf16"].clone()
    kn[:, :, L:] = float("nan")
    kn[:, :, L:L + (LP - L) // 2] = 1e4

    def k27(kv_len=L):
        kvi, ks = sf._subquant_pack_kv_blocks_cuda(kn, k_mean, vi, BK, kv_len)
        return kvi[:, :, :L], ks

    def k27_plain():
        kvi, ks = sf.subquant_pack_kv_plain(kn, k_mean, vi, BK, L)
        return kvi[:, :, :L], ks

    def k27_shifted():
        kvi, ks = k27()
        return kvi, ks.roll(1, -1)

    kvi, ksb = sf.subquant_pack_kv_plain(Kp["bf16"], k_mean, vi, BK, L)
    kp, vtp, _ = sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, BK, L)
    bs_args = (Q3["i8"], Q3["scale"], kvi, ksb, vcs, lut)

    def k28(kvi_=kvi, ks_=ksb, vcs_=vcs, lut_=lut):
        return si8._sparse_i8_planes_bs_cuda(Q3["i8"], Q3["scale"], kvi_, ks_,
                                             vcs_, lut_, scale, BQ, BK, L)

    # K29: K planes with a per-channel offset, mu their mean over the rows
    k29 = (Kp["bf16"].float() + randn(1, HEADS, 1, DH, dtype=torch.float32)
           ).bfloat16()
    mu29 = k29[:, :, :L].float().mean(2, keepdim=True)
    # K30: q of std 3, smooth-k'd k; the key row query 0 of head 0 leans on
    # most
    q3 = randn(B, L, HEADS, DH, std=3.0)
    ks_ = k - k.mean(dim=1, keepdim=True)
    j = int(torch.matmul(ks_[0, :, 0].float(), q3[0, 0, 0].float()).argmax())
    k_row2 = ks_.clone()
    k_row2[:, j] *= 2

    def k30(k_=ks_, kv_len=L):
        return fa._flash_i8qk_cuda(q3, k_, v, scale, kv_len)

    pairs = _sparse_pairs(lut, BQ, BK, L, L)
    n_kp = Kp["bf16"].numel()
    dense_ops = 2 * B * HEADS * L * L * DH
    sharp = dict(atol=SHARP_ATOL, rtol=RTOL)
    checks = [
        Check("K27", f"pack K|V, one scale a {BK}-row block, {HEADS}x{LP}x{DH}, "
              f"rows {L}..{LP - 1} 1e4 then NaN", k27, k27_plain,
              (kn, k_mean, vi), {"fp32": 4 * n_kp}, atol=0.0, rtol=SCALE_RTOL,
              faults={"statistic over the rows past L": lambda: k27(LP),
                      "scales one block off": k27_shifted}),
        Check("K28", f"int8 sparse block-scale topk {TOPK_BS} ({sel}/{LP // BK} "
              f"blocks) {BQ}/{BK}, q of std ~3 "
              f"{_form(_k28_form(LP, LP, L, BQ, BK), 'wgmma', f'K28 at {BQ}/{BK}')}", k28,
              lambda: si8.sparse_attention_i8_planes_bs_plain(
                  *bs_args, block_q=BQ, block_k=BK, kv_len=L),
              bs_args, {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs},
              yardsticks={"K7 (VT layout) on the same LUT and operands":
                          lambda: si8._sparse_i8_vt_cuda(
                              Q3["i8"], Q3["scale"], kp, vtp, ksb, vcs, lut,
                              scale, BQ, BK, L, None, None)},
              **sharp,
              faults={"last LUT entry dropped":
                      lambda: k28(lut_=lut[..., :-1].contiguous()),
                      "block-scale table shifted by one block":
                      lambda: k28(ks_=ksb.roll(1, -1)),
                      "vch left out": lambda: k28(vcs_=torch.ones_like(vcs))}),
        Check("K29", f"smooth-k per-row int8 planes {HEADS}x{LP}x{DH}",
              lambda: sf._subquant_planes_cuda(k29, mu29),
              lambda: sf.subquant_planes_plain(k29, mu29), (k29, mu29),
              {"fp32": 4 * n_kp}, atol=0.0, rtol=SCALE_RTOL,
              faults={"mu left out": lambda: sf._subquant_planes_cuda(
                  k29, torch.zeros_like(mu29))}),
        Check("K30", f"dense int8-QK self {L}x{L}, q of std 3", k30,
              lambda: fa.flash_attention_i8qk_plain(q3, ks_, v, scale, L),
              (q3, ks_, v), {"int8": dense_ops, "bf16": dense_ops},
              yardsticks={"SDPA of the shape (bf16 QK)": sdpa(q3, ks_, v),
                          "K4 (bf16 QK) on the same tensors":
                          lambda: fa._flash_cuda(q3, ks_, v, scale, L)},
              faults={f"K row {j}'s scale doubled": lambda: k30(k_=k_row2),
                      "kv_len mask 64 keys short": lambda: k30(kv_len=L - 64)}),
    ]

    def extra():
        clean = k28()
        pk = kvi.clone()
        pk[:, :, L:] = 127
        poisoned = k28(kvi_=pk)
        torch.cuda.synchronize()
        if not torch.equal(clean[:, :, :L], poisoned[:, :, :L]):
            raise AssertionError("K28: a poisoned tail changed live rows")
        _, ks_k = k27()
        if not torch.equal(ks_k, k27_plain()[1]):
            raise AssertionError("K27: block scales differ from the plain version's")
        for name, fn_ in (("K27", k27), ("K28", k28),
                          ("K29", lambda: sf._subquant_planes_cuda(k29, mu29)),
                          ("K30", k30)):
            a, b = fn_(), fn_()
            torch.cuda.synchronize()
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name}: two runs differ")
        print(f"phase2 K27-K30 tail and stability: K28 with K|V rows {L}..{LP - 1} "
              f"= 127: live rows unchanged | K27 block scales bit-equal to the "
              f"plain version's | two runs of each of K27-K30: bit-equal",
              flush=True)
    return checks, extra


# the K-block phase 2's K23 / K24 LUTs never select
ZERO_BLOCK = 5


def _without_block(lut, j: int, nK: int = -(-L // BK)):
    """lut with K-block j replaced, in each row that names it, by the
    smallest block id the row does not name: no Q-block selects j."""
    import numpy as np
    import torch
    a = lut.cpu().numpy().copy()
    for row in a.reshape(-1, a.shape[-1]):
        if j in row:
            row[row == j] = next(c for c in range(nK) if c != j and c not in row)
    return torch.from_numpy(a).to(lut.device)


def _bwd_checks(randn):
    """K23 and K24 at the 1.3B training shape (32,760 tokens, 12 heads,
    topk 0.1) against their plain versions on the card, in both forms of
    `kbwd::bwd_kernel` (each check asserting the one its launch takes):
    128-row tiles at blocks 512/256 (12 of 128 K blocks; every training
    path) and 64-row tiles at 64/64 (51 of 512; sagesla's straight-through
    backward at --sla_block 64).
    Inputs where every term matters: q of std 3, so each row's softmax
    leans on a few keys and its output o on a few rows of v; dO of N(0, 1),
    so delta (= dO . o) is of the order of dp and leaving it out of dS
    shows. (dO = 4 o + N(0, 1) makes |dq| ~30, where dq = scale (acc1 -
    delta acc2) / l, a difference of sums of bf16-rounded terms, is only
    good to ~0.1-0.4 absolute, and beyond atol 2e-2 + rtol 2e-2.) q, k, v, dO are views of
    buffers whose rows past L hold NaN; K-block ZERO_BLOCK is never
    selected. Planted faults K23's check must reject: acc2's term left out
    of dq (the kernel's dq plus scale delta P k / l, from the plain K3 over
    k as v), the last LUT entry of every row dropped, dq without `scale`;
    K24's: one inverse-LUT entry dropped, delta left out of dS, dk without
    `scale`. Returns (checks, a function of the further checks in each
    form: lse / delta in fp32, K24 ignoring (lse, delta) rows past L, dk =
    dv = 0 on the unselected block, two runs of each kernel bit-equal)."""
    import torch
    from turbodiffusion_tpu_torch.ops import flash_attention as fa
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    HEADS = G13.heads

    def view(t):                     # rows past L of the buffer: NaN
        t[:, L:] = float("nan")
        return t[:, :L]

    q, k, v = (view(randn(B, LP, HEADS, DH, std=sd)) for sd in (3.0, 1.0, 1.0))
    scale = DH ** -0.5
    do = view(randn(B, LP, HEADS, DH))
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    o_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    sdpa_bwd = {"dense SDPA backward (dq, dk, dv), for scale":
                lambda: torch.autograd.grad(o_s, (qs, ks, vs), do.transpose(1, 2),
                                            retain_graph=True)}

    def form(bq, bk):
        nK = -(-L // bk)
        lut = _without_block(get_block_map(q, k, TOPK, bq, bk)[1], ZERO_BLOCK, nK)
        inv = sb.inverse_lut(lut, nK)
        pairs = _sparse_pairs(lut, bq, bk, L, L)

        def k23(lut_=lut):
            dq, ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut_, bq, bk, scale, L)
            return dq, ld[:, :L]

        def k23_plain():
            dq, ld = sb.sparse_bwd_dq_plain(q, k, v, do, lut, bq, bk, scale, L)
            return dq, ld[:, :L]

        ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk, scale, L)[1]
        form23 = _form(f"{sb._sparse_bwd_dq_cuda.last_form}-row",
                       f"{128 if bq % 128 == 0 else 64}-row", f"K23 at {bq}/{bk}")

        def k24(inv_=inv, ld_=ld):
            return sb._sparse_bwd_dkv_cuda(q, k, v, do, ld_, inv_, bq, bk, scale, L)

        k24()
        form24 = _form(f"{sb._sparse_bwd_dkv_cuda.last_form}-row",
                       f"{128 if bk % 128 == 0 else 64}-row", f"K24 at {bq}/{bk}")
        dropped = inv.clone()
        bh, kb = divmod(int(inv[:, :, 0].argmax()), nK)
        dropped[bh, kb, 0] -= 1          # the row's last Q-block left out
        no_delta = ld.clone()
        no_delta[..., 1] = 0

        def unscaled():
            dk, dv = k24()
            return dk.float() / scale, dv

        def without_acc2():
            # dq + scale delta acc2 / l = scale acc1 / l; acc2 / l is the
            # plain K3 over k in v's place (bf16(P) k / l)
            dq, ld_ = k23()
            pk = fa.sparse_flash_attention_plain(q, k, k, lut, bq, bk, scale, L)
            delta = ld_[..., 1].reshape(B, HEADS, L).transpose(1, 2)[..., None]
            return dq.float() + scale * delta * pk.float(), ld_

        sel = lut.shape[-1]
        checks = [
            Check("K23", f"dq pass + (lse, delta), {sel}/{nK} blocks {bq}/{bk}, "
                  f"rows {L}..{LP - 1} NaN {form23}", k23, k23_plain, (q, k, v, do, lut),
                  {"bf16": 3 * 2 * DH * pairs}, yardsticks=sdpa_bwd if bq == BQ else {},
                  faults={"acc2's term left out of dq": without_acc2,
                          "the last LUT entry of every row dropped":
                          lambda: k23(lut_=lut[..., :-1].contiguous()),
                          "dq without scale":
                          lambda: (lambda r: (r[0].float() / scale, r[1]))(k23())}),
            Check("K24", f"inverse-LUT dk/dv pass {bq}/{bk}, block {ZERO_BLOCK} never "
                  f"selected {form24}",
                  k24, lambda: sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, bq, bk,
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
                raise AssertionError(f"K23 at {bq}/{bk}: (lse, delta) off by {ld_err}")
            poisoned = ld.clone()
            poisoned[:, L:] = float("nan")
            dk, dv = k24()
            dk_p, dv_p = k24(ld_=poisoned)
            blk = slice(ZERO_BLOCK * bk, (ZERO_BLOCK + 1) * bk)
            if not (torch.equal(dk, dk_p) and torch.equal(dv, dv_p)):
                raise AssertionError(f"K24 at {bq}/{bk} read (lse, delta) rows past L")
            if dk[:, blk].any() or dv[:, blk].any():
                raise AssertionError(f"K24 at {bq}/{bk}: block {ZERO_BLOCK} has "
                                     "non-zero dk / dv")
            dk2, dv2 = k24()
            if not (torch.equal(dq, k23()[0]) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2)):
                raise AssertionError(f"K23 / K24 at {bq}/{bk}: two runs differ")
            print(f"phase2 K23/K24 {bq}/{bk} tail and stability: (lse, delta) "
                  f"max_abs_err {ld_err:.3g} (tol atol 1e-3 + rtol 1e-4, fp32) | K24 "
                  f"with (lse, delta) rows {L}..{LP - 1} NaN: bit-equal | block "
                  f"{ZERO_BLOCK} (never selected): dk = dv = 0 exactly | two runs "
                  f"of each: bit-equal", flush=True)
        return checks, extra

    checks, extra = form(BQ, BK)
    checks64, extra64 = form(64, 64)

    def extras():
        extra()
        extra64()
    return checks + checks64, extras


K24_SEEDS = 8


def _k24_seeds():
    """K24's check over K24_SEEDS more draws of its inputs (each from a
    generator of its own, of the same kinds: q of std 3, k, v, dO of std
    1, NaN in the buffers' rows past L, K-block ZERO_BLOCK never selected,
    (lse, delta) from K23): the worst error of dk and of dv of each draw as
    a share of the unchanged tolerance (atol ATOL + rtol RTOL |want|),
    printed; any share above 1 fails."""
    import torch
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    HEADS, scale, nK = G13.heads, DH ** -0.5, -(-L // BK)
    shares = []
    for seed in range(K24_SEEDS):
        randn = _fresh_randn(2400 + seed)

        def view(std):
            t = randn(B, LP, HEADS, DH, std=std)
            t[:, L:] = float("nan")
            return t[:, :L]

        q, k, v, do = view(3.0), view(1.0), view(1.0), view(1.0)
        lut = _without_block(get_block_map(q, k, TOPK, BQ, BK)[1], ZERO_BLOCK)
        ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, BQ, BK, scale, L)[1]
        inv = sb.inverse_lut(lut, nK)
        got = sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, BQ, BK, scale, L)
        want = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, BQ, BK, scale, L)
        torch.cuda.synchronize()
        shares.append(tuple(float(((a.float() - b.float()).abs()
                                   / (ATOL + RTOL * b.float().abs())).max())
                            for a, b in zip(got, want)))
        del q, k, v, do, ld, got, want
    print("phase2 K24 over " + str(K24_SEEDS) + " seeds: worst error as a share of "
          f"atol {ATOL} + rtol {RTOL} |want| (dk, dv): "
          + ", ".join(f"seed {i} {a:.3f} / {b:.3f}" for i, (a, b) in enumerate(shares)),
          flush=True)
    bad = [i for i, sh in enumerate(shares) if max(sh) > 1]
    if bad:
        raise AssertionError(f"K24: seeds {bad} exceed the tolerance")


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
    dropped. Each check asserts the form its first launch took (the
    launcher's `.last_form`): K25 and K26 at 512/256 the wgmma kernel; K26 also at blocks 64/64 (51 of 512 K
    blocks), the mma.sync loop. No PyTorch call computes an attention JVP:
    the SDPA forward of the shape stands beside each for scale. Returns
    (checks, a function of the further check: two runs of each kernel
    bit-equal)."""
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

    def sparse_at(lut0, bq, bk):
        def kern(dk=None, dv=None, mu=True, lut_=lut0):
            k, v, dk_, dv_ = self_kv
            dk_ = dk_ if dk is None else torch.zeros_like(dk_)
            dv_ = dv_ if dv is None else torch.zeros_like(dv_)
            if not mu:
                return fj.sparse_flash_attention_jvp_plain(
                    q, k, v, dq, dk_, dv_, lut_, bq, bk, scale, L)
            return fj._sparse_flash_jvp_cuda(q, k, v, dq, dk_, dv_, lut_, bq,
                                             bk, scale, L)
        return kern

    sparse = sparse_at(lut, BQ, BK)
    lut64 = get_block_map(q, self_kv[0], TOPK, 64, 64)[1]
    sparse64 = sparse_at(lut64, 64, 64)
    k_self, k_text = dense(self_kv, L), dense(text_kv, TEXT)

    def form_of(kern, launcher, want, what):
        kern()                        # one launch, for the form it takes
        return _form(launcher.last_form, want, what)

    form_self = form_of(k_self, fj._flash_jvp_cuda, "wgmma", "K25 self")
    form_text = form_of(k_text, fj._flash_jvp_cuda, "wgmma", "K25 cross")
    form26 = form_of(sparse, fj._sparse_flash_jvp_cuda, "wgmma", f"K26 at {BQ}/{BK}")
    form64 = form_of(sparse64, fj._sparse_flash_jvp_cuda, "mma", "K26 at 64/64")
    ops25 = lambda lk: {"bf16": 12 * B * HEADS * L * lk * DH}   # noqa: E731
    scale_sdpa = lambda kv: {"SDPA forward, for scale": sdpa(q, *kv[:2])}  # noqa: E731
    sel = lut.shape[-1]
    checks = [
        Check("K25", f"dense self {L}x{L} (o, do), rows past L NaN {form_self}", k_self,
              lambda: fj.flash_attention_jvp_plain(q, *self_kv[:2], dq,
                                                   *self_kv[2:], scale, L),
              (q, dq, *self_kv), ops25(L), yardsticks=scale_sdpa(self_kv),
              atol=JVP_ATOL, faults=faults(k_self)),
        Check("K25", f"cross {L}x{TEXT} (o, do) {form_text}", k_text,
              lambda: fj.flash_attention_jvp_plain(q, *text_kv[:2], dq,
                                                   *text_kv[2:], scale, TEXT),
              (q, dq, *text_kv), ops25(TEXT), yardsticks=scale_sdpa(text_kv),
              atol=JVP_ATOL, faults=faults(k_text)),
        Check("K26", f"sparse {sel}/{-(-L // BK)} blocks {BQ}/{BK} (o, do) {form26}",
              sparse, lambda: fj.sparse_flash_attention_jvp_plain(
                  q, *self_kv[:2], dq, *self_kv[2:], lut, BQ, BK, scale, L),
              (q, dq, *self_kv, lut), {"bf16": 12 * DH * pairs},
              yardsticks=scale_sdpa(self_kv), atol=JVP_ATOL,
              faults={**faults(sparse), "last LUT entry of every row dropped":
                      lambda: sparse(lut_=lut[..., :-1].contiguous())}),
        Check("K26", f"sparse {lut64.shape[-1]}/{-(-L // 64)} blocks 64/64 (o, do) {form64}",
              sparse64, lambda: fj.sparse_flash_attention_jvp_plain(
                  q, *self_kv[:2], dq, *self_kv[2:], lut64, 64, 64, scale, L),
              (q, dq, *self_kv, lut64),
              {"bf16": 12 * DH * _sparse_pairs(lut64, 64, 64, L, L)}, atol=JVP_ATOL,
              faults={**faults(sparse64), "last LUT entry of every row dropped":
                      lambda: sparse64(lut_=lut64[..., :-1].contiguous())}),
    ]

    def extra():
        for name, kern in (("K25 self", k_self), ("K25 cross", k_text),
                           ("K26", sparse), ("K26 at 64/64", sparse64)):
            a, b = kern(), kern()
            torch.cuda.synchronize()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name}: two runs differ")
        print("phase2 K25/K26 stability: two runs of each (self, cross, "
              "sparse 512/256 and 64/64) bit-equal, with NaN in the rows past "
              "each length", flush=True)
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


def _k7_faults(i8_args, scale, bq: int = BQ, bk: int = BK):
    """K7's planted faults: the last LUT entry of every row dropped (one of
    the selected K blocks never read) and the V channel scales doubled."""
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    qi, qs, kp, vtp, ksb, vcs, lut = i8_args
    return {"last LUT entry dropped": lambda: si8._sparse_i8_vt_cuda(
                qi, qs, kp, vtp, ksb, vcs, lut[..., :-1].contiguous(), scale, bq, bk, L,
                None, None),
            "vch doubled": lambda: si8._sparse_i8_vt_cuda(
                qi, qs, kp, vtp, ksb, 2 * vcs, lut, scale, bq, bk, L, None, None)}


def _k7_edge_checks(q, k, Qp, Kp, k_mean, vi, vcs):
    """K7 at the 1.3B 480p planes off the main path's 512/256 blocks: blocks
    128/128 (25 of 256 K blocks: one 128-key chunk a K block, one 128-row
    block a Q block) and 512/256 with 32 of 128 K blocks (sel x block_k =
    8,192 keys a row, the most JAX's VT kernel takes), each rejecting the
    planted faults. The LUTs are the block maps of the raw q and k
    (get_block_map); K is repacked at the block size."""
    from turbodiffusion_tpu_torch.ops import sla_fused as sf
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    scale = DH ** -0.5
    out = []
    for bq, bk, topk in ((128, 128, TOPK), (BQ, BK, 0.25)):
        _, lut, sel = get_block_map(q, k, topk, bq, bk)
        kp, vtp, ksb = sf.subquant_pack_kvt_plain(Kp["bf16"], k_mean, vi, bk, L)
        args = (Qp["i8"], Qp["scale"], kp, vtp, ksb, vcs, lut)
        pairs = _sparse_pairs(lut, bq, bk, L, L)
        out.append(Check(
            "K7", f"int8 sparse ({sel}/{LP // bk} blocks, {sel * bk} keys a row) "
            f"{bq}/{bk}",
            lambda args=args, bq=bq, bk=bk: si8._sparse_i8_vt_cuda(
                *args, scale, bq, bk, L, None, None),
            lambda args=args, bq=bq, bk=bk: si8.sparse_attention_i8_vt_plain(
                *args, block_q=bq, block_k=bk, kv_len=L),
            args, {"int8": 2 * DH * pairs, "bf16": 2 * DH * pairs},
            faults=_k7_faults(args, scale, bq, bk)))
    return out


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
           proj_l=None, batch: int = 1, block_scale: bool = False,
           frames: int = 1, topk: float = TOPK):
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
    card runs the block twice, bit-equal. frames: 480p latent frames of
    1,560 tokens; topk the block map's ratio."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import (
        fused_sla_geometry, get_block_map)
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rope_cos_sin_full, rmsnorm_rope)
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.ops.sla_fused import (
        block_map_from_pooled, head_planes)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg(geo.model, attention, topk, quant_linear,
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
    T, Hs, Ws = frames, 30, 52
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
            # as sla_attention_fused: K5 takes each row's RMS itself
            kw = dict(num_heads=HEADS, eps=cfg.eps, pad_to=-(-n // 512) * 512)
            pq = head_planes(q_proj, sa.norm_q, *rope, pool=a.block_q,
                             quant=True, bf16_out=False, **kw)["pooled"]
            pk = head_planes(k_proj, sa.norm_k, *rope, pool=a.block_k,
                             **kw)["pooled"]
            return block_map_from_pooled(pq, pk, n, a.block_k, a.sla_topk)[0]
        q = rmsnorm_rope(q_proj, sa.norm_q, *rope, num_heads=HEADS, eps=cfg.eps)
        k = rmsnorm_rope(k_proj, sa.norm_k, *rope, num_heads=HEADS, eps=cfg.eps)
        return get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]

    launchers = _launchers()
    cpu_args = (x.cpu(), e0.cpu(), tuple(t.cpu() for t in rope))
    with torch.no_grad():
        # dense attention has no block map: every row compares
        nq = -(-n // a.block_q)
        same = torch.ones((batch, HEADS, nq), dtype=torch.bool)
        if a.backend != "dense":
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
             + (f" batch {batch}" if batch > 1 else "")
             + (f" topk {topk}" if topk != TOPK else ""))
    max_err, mean_err, _, want_mean, _ = _compare(
        f"phase3 {label} block", out.cpu()[:, keep], ref[:, keep], BLOCK_ATOL,
        BLOCK_RTOL)
    lut_note = ("dense, no block map" if a.backend == "dense" else
                f"LUT rows equal as sets {int(same.sum())}/{same.numel()} "
                f"(Q-blocks left out of the comparison: {bad_q})")
    print(f"phase3 {geo.model} {label} block L={n}"
          f"{' (proj_l != 0, linear branch on)' if lin else ''}: {lut_note} "
          f"| max_abs_err {max_err:.5g} "
          f"mean_abs_err {mean_err:.5g} (tol atol {BLOCK_ATOL} + rtol "
          f"{BLOCK_RTOL}; |want| mean {want_mean:.5g}) | card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | "
          f"{'two card runs bit-equal | ' if batch > 1 else ''}launches {counts}",
          flush=True)
    return counts


GRAD_REL = 0.05   # a gradient's relative L2 error, bf16 block, card vs CPU


# launches of a train block's forward and backward (1.3B, one latent frame,
# proj_l != 0): sla: K1-K4 and K21 forward, K23 + K24 backward (K1, K2, K4
# and K21 differentiate plain recomputes); fused sagesla: its fused forward
# (K6's linear kv, K7's epilogue), the composable path's recompute in the
# backward (K2 on q and k, K21; its sparse term launches no K20, whose value
# the VJP never reads) and its straight-through VJP (K23 + K24); sagesla at
# 64/64: the composable forward (K2 x 3, K20, K21)
TRAIN_BLOCK_LAUNCHES = {
    ("sla", 256): ({"K1": 3, "K2": 3, "K3": 1, "K4": 1, "K21": 1},
                   {"K23": 1, "K24": 1}),
    ("sagesla", 256): ({"K1": 3, "K2": 1, "K4": 1, "K5": 3, "K6": 1, "K7": 1},
                       {"K2": 2, "K21": 1, "K23": 1, "K24": 1}),
    ("sagesla", 64): ({"K1": 3, "K2": 3, "K4": 1, "K20": 1, "K21": 1},
                      {"K23": 1, "K24": 1}),
}


def phase3_train(attention: str = "sla", sla_block: int = 256,
                 device: str = "cuda"):
    """One full-width 1.3B block (linear branch on, proj_l != 0) at one 480p
    latent frame, forward and backward: the card (`sla`: K1-K4, K21 forward,
    K23 + K24 backward; `sagesla` at 512/256: the fused forward, JAX's
    composable VJP backward; at 64/64: K20 with its straight-through
    backward) against the plain versions on the CPU. The output on the Q
    blocks whose block-map rows (the fused path's pooled map and the
    composable path's) agree, and the gradient of every parameter and of
    the inputs (x, the time modulation, the context), with the cotangent
    zero on the rows of Q blocks whose LUT rows differ, so both sides
    differentiate the same function; no gradient may be zero. Exact
    launches of the forward and of the backward (TRAIN_BLOCK_LAUNCHES).
    Returns the counts of both."""
    import torch
    from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
    from turbodiffusion_tpu_torch.ops.attention import (
        fused_sla_geometry, get_block_map)
    from turbodiffusion_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, rmsnorm_rope, rope_cos_sin_full)
    from turbodiffusion_tpu_torch.ops.sla_fused import (
        block_map_from_pooled, head_planes)
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg

    cfg = make_wan_cfg(G13.model, attention, TOPK, sla_block=sla_block)
    a = cfg.attention
    fused = fused_sla_geometry(a, DH)
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
        """The composable path's LUT, and the fused path's where it runs."""
        with torch.no_grad():
            e = b.modulation.float()[None] + e0
            h = modulated_layer_norm(x, e[:, 1:2], e[:, 0:1], eps=cfg.eps)
            sa = b.self_attn
            q = rmsnorm_rope(sa.q(h), sa.norm_q, *rope, num_heads=G13.heads,
                             eps=cfg.eps)
            k = rmsnorm_rope(sa.k(h), sa.norm_k, *rope, num_heads=G13.heads,
                             eps=cfg.eps)
            luts = [get_block_map(q, k, a.sla_topk, a.block_q, a.block_k)[1]]
            if fused:
                kw = dict(num_heads=G13.heads, eps=cfg.eps,
                          pad_to=-(-n // 512) * 512)
                pq = head_planes(sa.q(h), sa.norm_q, *rope, pool=a.block_q,
                                 quant=True, bf16_out=False, **kw)["pooled"]
                pk = head_planes(sa.k(h), sa.norm_k, *rope, pool=a.block_k,
                                 **kw)["pooled"]
                luts.append(block_map_from_pooled(pq, pk, n, a.block_k,
                                                  a.sla_topk)[0])
            return [t.cpu() for t in luts]

    cpu = lambda *ts: tuple(t.cpu() for t in ts)  # noqa: E731
    same = None
    for lg, lc in zip(lut_of(blk, x, e0, rope),
                      lut_of(blk_cpu, *cpu(x, e0), cpu(*rope))):
        eq = (lg.sort(-1).values == lc.sort(-1).values).all(-1)
        same = eq if same is None else same & eq
    bad_q = sorted(set((~same).nonzero()[:, 2].tolist()))
    keep = torch.ones(n, dtype=torch.bool)
    for i in bad_q:
        keep[i * a.block_q:(i + 1) * a.block_q] = False
    if not keep.any():
        raise AssertionError("phase3 train: every Q-block's LUT differs")
    cot = cot * keep.to(dev)[None, :, None].to(cot.dtype)
    launchers = _launchers()

    def run(b, x, e0, ctx, rope, cot):
        """(output, gradients, forward launches, backward launches)."""
        ins = [t.detach().requires_grad_() for t in (x, e0, ctx)]
        params = [p for _, p in b.named_parameters()]
        for fn in launchers.values():
            fn.launches = 0
        out = b(ins[0], ins[1], rope, ins[2])
        fwd = {nm: fn.launches for nm, fn in launchers.items() if fn.launches}
        for fn in launchers.values():
            fn.launches = 0
        grads = torch.autograd.grad(out, ins + params, cot)
        bwd = {nm: fn.launches for nm, fn in launchers.items() if fn.launches}
        return out.detach(), grads, fwd, bwd

    t0 = time.perf_counter()
    out, grads, fwd, bwd = run(blk, x, e0, ctx, rope, cot)
    torch.cuda.synchronize()
    ms_gpu = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, ref_grads, _, _ = run(blk_cpu, *cpu(x, e0, ctx), cpu(*rope), cot.cpu())
    ms_cpu = (time.perf_counter() - t0) * 1e3
    label = f"{attention}{'' if sla_block == 256 else f' blocks {a.block_q}/{a.block_k}'}"
    max_err, mean_err, _, want_mean, _ = _compare(
        f"phase3 train {label} block output", out.cpu()[:, keep], ref[:, keep],
        BLOCK_ATOL, BLOCK_RTOL)
    names = ["x", "e0", "context"] + [nm for nm, _ in blk.named_parameters()]
    rel = {}
    for nm, gg, gw in zip(names, grads, ref_grads):
        gg, gw = gg.float().cpu(), gw.float()
        if not bool(torch.isfinite(gg).all()):
            raise AssertionError(f"phase3 train {label}: non-finite gradient of {nm}")
        if not gg.abs().max() > 0:
            raise AssertionError(f"phase3 train {label}: zero gradient of {nm}")
        rel[nm] = float((gg - gw).norm() / gw.norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL:
        raise AssertionError(f"phase3 train {label}: gradient of {worst} off by "
                             f"{rel[worst]:.3g} (relative L2) > {GRAD_REL}")
    want_fwd, want_bwd = TRAIN_BLOCK_LAUNCHES[(attention, sla_block)]
    if (fwd, bwd) != (want_fwd, want_bwd):
        raise AssertionError(f"phase3 train {label} launches forward {fwd}, "
                             f"backward {bwd} != {want_fwd}, {want_bwd}")
    print(f"phase3 {G13.model} {label} block forward + backward L={n} (proj_l "
          f"!= 0, linear branch on): LUT rows equal as sets {int(same.sum())}/"
          f"{same.numel()} (Q-blocks left out: {bad_q}) | output max_abs_err "
          f"{max_err:.5g} mean_abs_err {mean_err:.5g} (|want| mean "
          f"{want_mean:.5g}) | gradients of {len(names)} tensors (x, e0, "
          f"context, {len(names) - 3} parameters), none zero: relative L2 error "
          f"max {rel[worst]:.4g} ({worst}), median "
          f"{statistics.median(rel.values()):.4g} (tol {GRAD_REL}) | card "
          f"{ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | launches forward "
          f"{fwd}, backward {bwd}", flush=True)
    return {k: fwd.get(k, 0) + bwd.get(k, 0) for k in {*fwd, *bwd}}


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
    forms = _jvp_forms(launchers, counts)
    print(f"phase3 {G13.model} {attention} block, sCM tangent pass L={n}"
          f"{' (proj_l != 0)' if sla else ''}: o relative L2 error "
          f"{rel['o']:.4g}, do {rel['do']:.4g} (tol {JVP_REL}; |do| mean "
          f"{float(want[1].float().abs().mean()):.4g}; Q-blocks left out: "
          f"{bad_q}) | card {ms_gpu:.1f} ms, CPU plain {ms_cpu:.1f} ms | "
          f"launches {counts} | forms {forms}", flush=True)
    return counts


def _jvp_forms(launchers, counts) -> dict:
    """The form of K25's and K26's last launch where `counts` has them; each
    must be the wgmma kernel (every path runs 512/256)."""
    forms = {n: launchers[n].last_form for n in ("K25", "K26") if counts.get(n)}
    if any(f != "wgmma" for f in forms.values()):
        raise AssertionError(f"K25/K26 took {forms}, not the wgmma form")
    return forms


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


def _block_scale_state(geo: Geometry):
    """A seeded random `sagesla` DiT of geo's widths with every block linear
    quantised to 128x128 block scales on the card
    (`quantize_wan_blocks(mode="block", fuse_qkv=False)`), as the
    reference-named state dict `wan_state_dict_from_params` gives: what
    `load_dit` reads from a `-quant` checkpoint, with no file written.
    Returns (state dict, the model's state the load must reproduce)."""
    from turbodiffusion_tpu_torch.models.wan import init_wan_params
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
    from turbodiffusion_tpu_torch.utils.checkpoint import (
        wan_state_dict_from_params)
    t0 = time.perf_counter()
    cfg = make_wan_cfg(geo.model, "sagesla", TOPK)
    model = init_wan_params(cfg, seed=13, device="cuda")
    quantize_wan_blocks(model.blocks, mode="block", fuse_qkv=False)
    sd = wan_state_dict_from_params(model, cfg)
    print(f"phase4 {geo.model} block-scale state dict: {len(sd)} tensors in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return sd, model.state_dict()


def phase4(label: str, geo: Geometry, attention: str, quant_linear: bool,
           requests: int, create_kw: dict, loaded_state=None):
    """`requests` 4-step 81-frame requests (480p unless create_kw names a
    "resolution") through WanPipeline.create(geo.model,
    attention_type=attention, quant_linear=quant_linear, **create_kw), then
    one traced DiT call (`_profile_denoise`); frees the pipeline and returns
    the launch counts of the last request. loaded_state: (the DiT state the
    checkpoint in create_kw must load into, tensor for tensor; whether the
    linear branch is on). Per request: each phase's time and peak, and the
    VAE decode's own peak (at most VAE_OWN_PEAK_MAX_GIB at 480p)."""
    import torch
    from turbodiffusion_tpu_torch.config import VIDEO_RES_SIZE_INFO, GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    create_kw = dict(create_kw)
    res = create_kw.pop("resolution", "480p")
    width, height = VIDEO_RES_SIZE_INFO[res]["16:9"]
    launchers = _launchers()
    want = {n: EXPECTED_LAUNCHES[label].get(n, 0) for n in launchers}
    t0 = time.perf_counter()
    pipe = WanPipeline.create(model=geo.model, attention_type=attention,
                              quant_linear=quant_linear, seed=0, device="cuda",
                              **{"sla_topk": TOPK, **create_kw})
    torch.cuda.synchronize()
    print(f"phase4 {label} create: {time.perf_counter() - t0:.1f} s, "
          f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    if loaded_state is not None:
        state, linear_branch = loaded_state
        got = pipe.dit.state_dict()
        bad = [k for k, v in state.items()
               if k not in got or not torch.equal(got[k], v)]
        if bad or len(got) != len(state) \
                or pipe.cfg.attention.linear_branch != linear_branch:
            raise AssertionError(f"{label}: loaded DiT differs from the written "
                                 f"one at {bad[:5]} (linear branch "
                                 f"{pipe.cfg.attention.linear_branch})")
        print(f"phase4 {label} load: all {len(got)} tensors equal the written "
              f"model's (bf16 where a file is), linear branch "
              f"{'on' if linear_branch else 'off'}", flush=True)
    counts = None
    for r in range(requests):
        gen = GenerationConfig(num_steps=4, num_frames=81, resolution=res,
                               aspect_ratio="16:9", seed=r)
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
        if tuple(video.shape) != (1, 3, 81, height, width):
            raise AssertionError(f"video shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        lo, hi = float(video.min()), float(video.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"video outside [0, 1]: [{lo}, {hi}]")
        own = timings["vae_decode_peak_gib"] - timings["vae_decode_start_gib"]
        if res == "480p" and own > VAE_OWN_PEAK_MAX_GIB:
            raise AssertionError(f"{label}: the VAE decode rose {own:.2f} GiB "
                                 f"above its start (> {VAE_OWN_PEAK_MAX_GIB})")
        peaks = " | ".join(
            f"{ph} peak {timings[f'{ph}_peak_gib']:.2f} GiB from "
            f"{timings[f'{ph}_start_gib']:.2f}"
            for ph in ("text_encode", "denoise", "vae_decode"))
        print(f"phase4 {label} request {r}: text-encode "
              f"{timings['text_encode_ms']:.1f} ms | denoise "
              f"{timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{timings['peak_gib']:.2f} GiB ({peaks}; the decode's own "
              f"{own:.2f}) | video {tuple(video.shape)} in [{lo:.3f}, "
              f"{hi:.3f}] | launches {counts}", flush=True)
    _profile_denoise(pipe, label, res)
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
    # `-- model.attention.backend=sagesla`, which applies to the teacher
    # too, as in JAX (its train.py:118): two forwards of the fused path, K1
    # 3, K2 1 and K4 1 (cross), K5 3, K6 1, K7 1 a block; the student's
    # backward the composable VJP, K2 2, K21 1, K23 1, K24 1
    "sagesla none": {"K1": 180, "K2": 120, "K4": 60, "K5": 180, "K6": 60,
                     "K7": 60, "K21": 30, "K23": 30, "K24": 30},
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
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{label} step {it}: loss {loss}, gradient "
                                     f"norm {gnorm}")
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
                    f"| loss {loss:.6g} | grad norm {gnorm:.4g} | peak "
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
    profiled; (2) 1 step at 480p/21f, --remat none; (3) the same with
    `-- model.attention.backend=sagesla` (fused sagesla forward, its
    composable VJP backward); (4) the checkpoint round trip at 2 layers,
    full width (21f): 1 step saved, then a run that resumes from it must
    start from the saved model, optimizer state and generator state and
    take step 2. Returns run 1's last step's launch counts."""
    import torch
    from turbodiffusion_tpu_torch.scripts import train
    from turbodiffusion_tpu_torch.training.trainer import Callback
    base = ["--experiment", "sla", "--model", G13.model, "--teacher_ckpt",
            ckpt, "--seed", "0", "--lr", "1e-5"]

    class PerturbStudent(Callback):
        """The override makes the teacher sagesla too (as in JAX), so the
        student would start equal to it: loss and gradient exactly 0. A
        head N(0, 0.02^2) apart gives the backward something to carry."""

        def on_train_start(self, state):
            g = torch.Generator(device="cuda").manual_seed(14)
            with torch.no_grad():
                w = state.params.head.head.weight
                w.add_(0.02 * torch.randn(w.shape, generator=g, device=w.device))

    # (label, frames, remat, steps, profiled step, launches, overrides,
    # callbacks run before the probe)
    runs = [("block_wise 81f", 81, "block_wise", 3, 2, "block_wise", [], []),
            ("none 21f", 21, "none", 1, None, "none", [], []),
            ("sagesla none 21f", 21, "none", 1, None, "sagesla none",
             ["model.attention.backend=sagesla"], [PerturbStudent()])]
    peaks, counts = {}, None
    for label, frames, remat, steps, prof_step, launches, ovr, first in runs:
        probe = _step_probe(label, TRAIN_LAUNCHES[launches], prof_step)
        t0 = time.perf_counter()
        train.main(base + ["--data", shards[frames], "--remat", remat,
                           "--max_iter", str(steps), "--ckpt_dir", "",
                           "--time_phases", "--", "trainer.log_every=1", *ovr],
                   callbacks=[*first, probe])
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
            forms = _jvp_forms(launchers, counts)
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
                    f"{moved} | launches {self.counts[phase]}"
                    + (f" | forms {forms}" if forms else ""))
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
    model.attention.backend=sla`, the same 2 iterations, the student's
    profiled; each
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
                                    ("sla", ["model.attention.backend=sla"], 2,
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
    # K12 (either form) before K1, whose row kernel shares its name
    ("K12", ("mln_kernel<true",) + tuple(f"mln_rows_kernel<{v}, true>" for v in range(1, 9))),
    ("K1", ("mln_rows_kernel", "mln_kernel<false")),
    ("K2", ("rmsrope_rows_kernel", "rmsrope_kernel")), ("K13", ("unfold_quant_kernel",)),
    ("K14", ("cross_qout_kernel<false>",)), ("K15", ("row_rms_inv_kernel",)),
    ("K16", ("unfold_quant_wide_kernel",)), ("K17", ("cross_qout_kernel<true>",)),
    # K3 in either form (K4's kernel with the sparse walk, or the mma.sync
    # loop), K4, K20 and K30 (K4's kernel in its int8-QK forms; their first
    # launches, the int8 rows, apart); K7, K28 and K19 in either form (K7's kernel by
    # its source layout, or the mma.sync loop)
    ("K3", ("sparse_flash_fwd_kernel", "flash_fwd_kernel<1>")),
    ("K4", ("flash_fwd_kernel<0>",)), ("K20", ("flash_fwd_kernel<2>",)),
    ("K30", ("flash_fwd_kernel<3>",)),
    ("K20/K30 int8 rows", ("i8qk_quant_kernel",)),
    ("K5", ("head_planes_rows_kernel",)), ("K6", ("k6::",)),
    ("K27", ("subquant_block_kernel",)),
    ("K21 kv", ("k21::kv",)), ("K7", ("sparse_i8_vt_kernel<0>",)),
    ("K18", ("subquant_pack_kv_kernel<true>",)),
    ("K29", ("subquant_pack_kv_kernel<false>",)),
    ("K19", ("sparse_i8_planes_kernel<false>", "sparse_i8_vt_kernel<2>")),
    ("K28", ("sparse_i8_planes_kernel<true>", "sparse_i8_vt_kernel<1>")),
    ("K21 apply", ("k21::apply_kernel",)),
    # K8-K11 and K22 before the library GEMMs: K9's and K22's names hold
    # "gemm"
    ("K8", ("quantize_rows_kernel",)), ("K9", ("postscale_gemm_kernel",)),
    ("K10", ("w8a8_ffn_kernel<1>",)), ("K11", ("w8a8_ffn_kernel<2>",)),
    ("K22", ("block_gemm_kernel",)),
    # K23 / K24: kbwd::bwd_kernel<pass, tile rows>, either form
    ("K23", ("kbwd::bwd_kernel<0",)), ("K24", ("kbwd::bwd_kernel<1",)),
    # K25 and K26 in either form (the wgmma kernel, or K26's mma.sync loop)
    ("K25", ("jvp_fwd_kernel<false>",)),
    ("K26", ("jvp_fwd_kernel<true>", "sparse_jvp_mma_kernel")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("GEMM", ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")),
    ("top-k/sort", ("topk", "sort", "radix")), ("reduce", ("reduce",)),
]


def _profile_denoise(pipe, label: str, resolution: str = "480p"):
    """One DiT call of an 81-frame request (a quarter of its denoise; the
    pipeline's requests warmed it) under torch.profiler: device time by
    kernel category and the device's idle share, as one printed line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.sampler import latent_shape
    gen = GenerationConfig(num_frames=81, resolution=resolution,
                           aspect_ratio="16:9")
    emb = pipe.text_encoder("a red fox running through snow").to(pipe.cfg.dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, *latent_shape(gen)), generator=g, device="cuda")
    t = torch.full((1, 1), 500.0, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pipe.dit(x, t, emb)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"phase4 {label} profile, one DiT call: wall {wall:.1f} ms, "
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
                 ("K1", "K2", "K4", "K5", "K6", "K7", "K22")),
                # 6 latent frames (9,360 tokens), topk 0.9: 33 of 37 K
                # blocks, 33 x 256 = 8,448 keys a row > 8,192
                ("k27k28", dict(attention="sagesla", quant_linear=True,
                                frames=6, topk=0.9), ("K27", "K28", "K21"))):
            block_counts[label] = phase3(**kw)
            missing = [n for n in must if not block_counts[label].get(n)]
            if missing:
                raise AssertionError(f"phase3 {label}: {missing} never launched")
        bs = {n: block_counts["k27k28"].get(n, 0)
              for n in ("K27", "K28", "K21", "K6", "K7")}
        if bs != {"K27": 1, "K28": 1, "K21": 1, "K6": 0, "K7": 0}:
            raise AssertionError(f"phase3 block-scale pair launches {bs}")
        phase3("sagesla", True, geo=G14)
        # the 14B's bf16 compositions (K2 at 5120) and its block-scaled one;
        # fused sagesla takes the rows' RMS in K5, no K15
        for label, kw, must in (
                ("sagesla", dict(attention="sagesla"),
                 ("K1", "K2", "K4", "K5", "K6", "K7")),
                ("sla", dict(attention="sla"), ("K1", "K2", "K3", "K4")),
                ("original", dict(attention="original"), ("K1", "K2", "K4")),
                ("block-scale", dict(attention="sagesla", block_scale=True),
                 ("K1", "K2", "K4", "K5", "K6", "K7", "K22"))):
            got = phase3(geo=G14, **kw)
            missing = [n for n in must if not got.get(n)]
            if missing:
                raise AssertionError(f"phase3 14B {label}: {missing} never launched")
            if got.get("K15"):
                raise AssertionError(f"phase3 14B {label}: K15 launched {got['K15']} times")
        for attention, sla_block in TRAIN_BLOCK_LAUNCHES:
            phase3_train(attention, sla_block)
        for attention in ("original", "sla"):
            phase3_jvp(attention)
    counts = {}
    if 4 in phases:
        # a kernel's launches come from the first 14B path that runs it,
        # else from the first 1.3B path; K21, which no request runs (random
        # weights: proj_l = 0), from the phase-3 block of the row path
        by_path = []
        for path in PATHS:
            label, geo, *_, create_kw = path
            if create_kw.get("dit_path") == "block":
                sd, state = _block_scale_state(geo)
                by_path.append((geo, phase4(*path[:5], {**create_kw, "dit_path": sd},
                                            loaded_state=(state, False))))
                del sd, state
            elif "dit_path" in create_kw:
                from turbodiffusion_tpu_torch.ops._build import BUILD_DIR
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    ckpt, state = _write_checkpoint(tmp)
                    by_path.append((geo, phase4(*path[:5],
                                                {**create_kw, "dit_path": ckpt},
                                                loaded_state=(state, True))))
                    del state
            else:
                by_path.append((geo, phase4(*path)))
        for geo, path_counts in sorted(by_path, key=lambda gc_: gc_[0] != G14):
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
