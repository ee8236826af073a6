"""Where a K7 block spends its time: clock64 sums per block and role.

Usage:
  python tools/stamp_k7.py [--models 1.3b,14b]

Copies `turbodiffusion_tpu_torch` into a temporary directory under its
`_build/`, inserts into the copy of `csrc/sparse_i8_attention.cu` clock64
sums (per block: the loader thread, the first converter thread and thread 0
of each consumer warpgroup) and a C entry that copies the table out, builds
that copy, runs K7 (`_sparse_i8_vt_cuda`) at the 480p sagesla call of
`tools/time_k9_k7.py` (blocks 512/256, 12 of 128 K blocks, no linear
epilogue) and prints one JSON line per (model, role): the median over
blocks of each part in SM clock cycles, and the card's name and power
limit. The package itself is not changed; the stamps cost a few
instructions a chunk, so the times of `tools/time_k9_k7.py` are the
uninstrumented ones. Parts: loader: waiting for a free stage, total;
converter: waiting for a chunk's bytes, converting; consumer: Q wait,
loop top (the K block, its scale), waiting for the chunk's bytes, issuing
QK, issuing P V (its wait for the converted V included), waiting for QK,
the softmax, waiting for P V, the rescale and P's packing, total.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

MAX_BLOCKS = 16384
PARTS = {0: ["free-stage wait", "total"],
         1: ["bytes wait", "converting"],
         2: ["Q wait", "loop top", "bytes wait", "QK issue", "P V issue",
             "QK wait", "softmax", "P V wait", "rescale + pack", "total"]}

# (anchor in csrc/sparse_i8_attention.cu, replacement: the anchor with
# stamps around it); `acc_st` holds a thread's sums, `ST(k, code)` adds the
# cycles `code` takes to sum k
EDITS = [
    ("namespace k7 {\n", f"""namespace k7 {{
__device__ long long g_st[{MAX_BLOCKS}][4][10];
#define ST(k, code) {{ const long long _t = clock64(); code; acc_st[k] += clock64() - _t; }}
__device__ __forceinline__ void st_out(const long long* acc, int role) {{
  const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (b < {MAX_BLOCKS})
    for (int k = 0; k < 10; ++k) g_st[b][role][k] = acc[k];
}}
"""),
    # loader
    ("""      int i = 0;
      for_chunks([&](int kb, int off) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);""",
     """      long long acc_st[10] = {0};
      const long long t_start = clock64();
      int i = 0;
      for_chunks([&](int kb, int off) {
        const int s = i % kStages;
        ST(0, if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1));"""),
    ("""        ++i;
      });
    } else if (tid >= 32) {""", """        ++i;
      });
      acc_st[1] = clock64() - t_start;
      st_out(acc_st, 0);
    } else if (tid >= 32) {
      long long acc_st[10] = {0};"""),
    # converters
    ("""        mbar_wait(full0 + 8 * s, (i / kStages) & 1);
        const unsigned char* vi""", """        ST(0, mbar_wait(full0 + 8 * s, (i / kStages) & 1));
        const long long t_conv = clock64();
        const unsigned char* vi"""),
    ("""        fence_async_shared();   // wgmma reads them through the async proxy""",
     """        acc_st[1] += clock64() - t_conv;
        fence_async_shared();   // wgmma reads them through the async proxy"""),
    ("""        ++i;
      });
    }
    return;""", """        ++i;
      });
      if (tid == 32) st_out(acc_st, 1);
    }
    return;"""),
    # consumers
    ("""  // O += bf16(P) V of the chunk in stage s""", """  long long acc_st[10] = {0};
  const long long t_start = clock64();
  // O += bf16(P) V of the chunk in stage s"""),
    ("""  mbar_wait(qbar, 0);
  int i = 0, prev = -1;""", """  ST(0, mbar_wait(qbar, 0));
  int i = 0, prev = -1;"""),
    ("""    const int key0 = kb * p.block_k + off;
    const int s = i % kStages;""", """    long long t_part = clock64();
    const int key0 = kb * p.block_k + off;
    const int s = i % kStages;"""),
    ("""    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    // S = Q K^T""", """    acc_st[1] += clock64() - t_part;
    ST(2, mbar_wait(full0 + 8 * s, (i / kStages) & 1));
    t_part = clock64();
    // S = Q K^T"""),
    ("""    wgmma_commit();
    if (prev >= 0) issue_pv(prev, i - 1);
    if (prev >= 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    reg_fence<64>(sc);
""", """    wgmma_commit();
    acc_st[3] += clock64() - t_part;
    ST(4, if (prev >= 0) issue_pv(prev, i - 1));
    ST(5, if (prev >= 0) wgmma_wait<1>(); else wgmma_wait<0>(); reg_fence<64>(sc));
    t_part = clock64();
"""),
    ("""    // the previous P V is done: its stage is free, O and P are ours
    wgmma_wait<0>();
    reg_fence<64>(o);
    reg_fence<32>(pa);""", """    acc_st[6] += clock64() - t_part;
    // the previous P V is done: its stage is free, O and P are ours
    ST(7, wgmma_wait<0>(); reg_fence<64>(o); reg_fence<32>(pa));
    t_part = clock64();"""),
    ("""    prev = s;
    ++i;
  });
  if (prev >= 0) {""", """    acc_st[8] += clock64() - t_part;
    prev = s;
    ++i;
  });
  if (prev >= 0) {"""),
    ("""  // o = O / max(l, 1e-20) * vch""", """  acc_st[9] = clock64() - t_start;
  if (lt == 0) st_out(acc_st, 2 + cw);
  // o = O / max(l, 1e-20) * vch"""),
]
ENTRY = f"""
extern "C" int tdx_k7_stamps(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, k7::g_st, sizeof(long long) * {MAX_BLOCKS} * 4 * 10);
}}
"""


def _instrument(src: str) -> str:
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"stamp_k7: anchor not found once: {anchor!r}")
        src = src.replace(anchor, new, 1)
    return src + ENTRY


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", default="1.3b,14b")
    args = p.parse_args(argv)
    pkg = Path(__file__).resolve().parents[1] / "turbodiffusion_tpu_torch"
    (pkg / "_build").mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=pkg / "_build") as tmp:
        copy = Path(tmp) / "turbodiffusion_tpu_torch"
        shutil.copytree(pkg, copy, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        cu = copy / "csrc" / "sparse_i8_attention.cu"
        cu.write_text(_instrument(cu.read_text()))
        sys.path.insert(0, tmp)
        return _run(args)


def _run(args) -> int:
    import numpy as np
    import torch
    from turbodiffusion_tpu_torch.ops import _build
    from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8

    if not torch.cuda.is_available():
        raise SystemExit("stamp_k7: needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "time_k9_k7", Path(__file__).resolve().parent / "time_k9_k7.py")
    tk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tk)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    fetch = _build.load()._lib.tdx_k7_stamps
    fetch.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).bfloat16()

    for model in args.models.split(","):
        args7, _ = tk._k7_operands(model, randn, g)
        for _ in range(3):
            si8._sparse_i8_vt_cuda(*args7, tk.DH ** -0.5, tk.BQ, tk.BK, tk.L, None, None)
        torch.cuda.synchronize()
        table = np.zeros((MAX_BLOCKS, 4, 10), np.int64)
        if fetch(table.ctypes.data) != 0:
            raise SystemExit("stamp_k7: copying the stamps failed")
        n = min(MAX_BLOCKS, args7[0].shape[1] * tk.LP // 128)
        t = table[:n]
        for role, name in ((0, "loader"), (1, "converter"), (2, "consumer 0"),
                           (3, "consumer 1")):
            parts = PARTS[min(role, 2)]
            rec = {"model": model, "role": name, "blocks": n, "card": card}
            rec.update({part: float(np.median(t[:, role, k])) for k, part in enumerate(parts)})
            print(json.dumps(rec), flush=True)
        del args7
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
