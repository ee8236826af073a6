"""Where a K10 / K11 block spends its time: clock64 stamps per block.

Usage:
  python tools/stamp_w8a8_ffn.py [--models 1.3b,14b] [--rows 32760]

Copies `turbodiffusion_tpu_torch` into a temporary directory under its
`_build/`, inserts into the copy of `csrc/quant.cu` a table of clock64
stamps (one row per block, written by the first consumer thread at the
phase boundaries named below) and a C entry that copies the table out,
builds that copy, runs K10 (fc1 + GELU -> int8) and K11 (fc2 over BN-wide
K slabs, gate, residual) at the 1.3B / 14B FFN shapes of a 480p/81f
request, and prints one JSON line per (model, kernel): the median over
blocks of each phase in SM clock cycles, and the card's name and power
limit. The stamps cost a few global stores a block; the times of
`tools/time_w8a8_ffn.py` are the uninstrumented ones. The package itself is
not changed. Phases: start -> consumer up (barrier init, cluster barrier,
setmaxnreg) -> first tile (its TMA latency) -> loop done (the main loop)
-> K10: gelu done (scales, bias, GELU) -> amax pushed (row maxima to the
cluster) -> cluster sync -> quantised (int8 tile into shared memory);
K11: epilogue (bf16 stores) -> cluster sync.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

MODELS = {"1.3b": (1536, 8960), "14b": (5120, 13824)}   # dim, FFN
MAX_BLOCKS = 40000
K10_PHASES = ["start", "consumer up", "first tile", "loop done", "gelu done",
              "amax pushed", "cluster sync", "quantised"]
K11_PHASES = ["start", "consumer up", "first tile", "loop done", "epilogue",
              "cluster sync"]

# (anchor in w8a8_ffn_kernel's text in csrc/quant.cu, text inserted before it)
KERNEL = ("w8a8_ffn_kernel(const __grid_constant__",
          "// once per mode: the shared-memory size")
STAMPS = [
    ("  if (tid == 0) {\n#pragma unroll 1\n    for (int s = 0; s < STAGES; ++s) {",
     "  if (tid == kWG) stamp(MODE, 0);\n"),
    ("  const int cw = tid / kWG - 1, lt = tid % kWG",
     "  if (tid == kWG) stamp(MODE, 1);\n"),
    ("    const uint32_t a = base + s * Ly::STAGE_BYTES + cw * 64 * MS * kTK;",
     "    if (kt == 0 && tid == kWG) stamp(MODE, 2);\n"),
    ("\n  if constexpr (MODE == kQout) {\n    // fp32 values",
     "  if (tid == kWG) stamp(MODE, 3);\n"),
    ("    // each row's amax over the tile (its four lanes)",
     "    if (tid == kWG) stamp(MODE, 4);\n"),
    ("    // every block's maxima written; every block's main loop done",
     "    if (tid == kWG) stamp(MODE, 5);\n"),
    ("    unsigned char* otile = smem;", "    if (tid == kWG) stamp(MODE, 6);\n"),
    ("    asm volatile(\"bar.sync 1, %0;\"", "    if (tid == kWG) stamp(MODE, 7);\n"),
    ("    // no block exits while a remote arrive or multicast may still reach it",
     "    if (tid == kWG) stamp(MODE, 4);\n"),
    ("\n  }\n}\n\n", "\n    if (tid == kWG) stamp(MODE, 5);"),
]
TABLE = f"""
__device__ long long g_stamps[2][{MAX_BLOCKS}][8];
__device__ __forceinline__ void stamp(int mode, int k) {{
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (b < {MAX_BLOCKS}) g_stamps[mode - 1][b][k] = clock64();
}}
"""
ENTRY = f"""
extern "C" int tdx_ffn_stamps(void* host, int mode) {{
  return (int)cudaMemcpyFromSymbol(host, ffn::g_stamps, sizeof(long long) * {MAX_BLOCKS} * 8,
                                   sizeof(long long) * {MAX_BLOCKS} * 8 * (mode - 1));
}}
"""


def _instrument(src: str) -> str:
    src = src.replace("namespace ffn {\n", "namespace ffn {\n" + TABLE, 1)
    i = src.index(KERNEL[0])
    j = src.index(KERNEL[1], i)
    body = src[i:j]
    for anchor, text in STAMPS:
        if body.count(anchor) != 1:
            raise SystemExit(f"stamp_w8a8_ffn: anchor not found once: {anchor!r}")
        body = body.replace(anchor, text + anchor, 1)
    return src[:i] + body + src[j:] + ENTRY


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", default="1.3b,14b")
    p.add_argument("--rows", type=int, default=32760)
    args = p.parse_args(argv)
    pkg = Path(__file__).resolve().parents[1] / "turbodiffusion_tpu_torch"
    (pkg / "_build").mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=pkg / "_build") as tmp:
        copy = Path(tmp) / "turbodiffusion_tpu_torch"
        shutil.copytree(pkg, copy, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        quant_cu = copy / "csrc" / "quant.cu"
        quant_cu.write_text(_instrument(quant_cu.read_text()))
        sys.path.insert(0, tmp)
        return _run(args)


def _run(args) -> int:
    import numpy as np
    import torch
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import quant as qt

    if not torch.cuda.is_available():
        raise SystemExit("stamp_w8a8_ffn: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    fetch = _build.load()._lib.tdx_ffn_stamps
    fetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    M = args.rows
    for model in args.models.split(","):
        dim, ffn = MODELS[model]
        bn = qt.pick_bn_div(ffn)
        xq, rs = qt.quantize_rows_int8_plain(randn(M, dim))
        w1, s1 = qt.quantize_int8_postscale(randn(ffn, dim, std=dim ** -0.5))
        w2, s2 = qt.quantize_int8_postscale(randn(dim, ffn, std=ffn ** -0.5))
        b1, b2, res = randn(ffn, std=0.1), randn(dim, std=0.1), randn(M, dim)
        gate = randn(dim, std=0.5).float()
        hq, hs = qt.int8_gemm_postscale_qout_plain(xq, rs, w1, s1, b1,
                                                   act="gelu_tanh")
        for mode, name, phases, call in (
                (1, "K10", K10_PHASES,
                 lambda: qt._int8_gemm_qout_cuda(xq, rs, w1, s1, b1, "gelu_tanh")),
                (2, "K11", K11_PHASES,
                 lambda: qt._int8_gemm_blockact_cuda(hq, hs, w2, s2, b2, None, bn,
                                                     gate, res))):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            table = np.zeros((MAX_BLOCKS, 8), np.int64)
            if fetch(table.ctypes.data, mode) != 0:
                raise SystemExit("stamp_w8a8_ffn: copying the stamps failed")
            blocks = int((table[:, 0] != 0).sum())
            t = table[:blocks]
            rec = {"model": model, "kernel": name, "blocks": blocks, "card": card}
            for k in range(1, len(phases)):
                rec[f"{phases[k - 1]} -> {phases[k]}"] = statistics.median(
                    (t[:, k] - t[:, k - 1]).tolist())
            rec["total"] = statistics.median((t[:, len(phases) - 1] - t[:, 0]).tolist())
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
