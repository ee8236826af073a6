"""Time 81-frame T2V requests of the port's Wan2.1 models on the card.

Usage:
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --attention_type \
      sagesla --quant_linear --sla_topk 0.3 --requests 3 [--root DIR]
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --model Wan2.1-14B \
      --resolution 720p --requests 2
  (also --v_quant row, --sla_block 64: the CLI's flags)

Builds `WanPipeline.create` with seeded random weights, runs `--requests`
4-step requests of seeds 0, 1, ... and prints a line for each: the
pipeline's text-encode, denoise and VAE-decode times (CUDA events), the
request's peak memory, each phase's peak and the allocation at its start
(where the package's pipeline reports them), and the launches of every
kernel launcher found in
`turbodiffusion_tpu_torch.ops` (each function with a `.launches` count),
by launcher name. `--root DIR` imports the package from the checkout at DIR
instead (an older commit unpacked beside this one, say), so that two trees
are timed by the same script on one card, one process each. The last line
is a JSON object with the denoise and VAE-decode times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
import time
from pathlib import Path


def _launchers(ops) -> dict:
    """{module.function: function} for every launch-counted function."""
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                out[f"{info.name}.{name}"] = fn
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--model", default="Wan2.1-1.3B")
    p.add_argument("--resolution", default="480p")
    p.add_argument("--attention_type", default="sagesla")
    p.add_argument("--sla_topk", type=float, default=0.1)
    p.add_argument("--quant_linear", action="store_true")
    p.add_argument("--v_quant", default="channel")
    p.add_argument("--sla_block", type=int, default=256)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    # the package of --root, else of the checkout this script lies in
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))

    import torch
    from turbodiffusion_tpu_torch import ops
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    print(f"{args.label} package {ops.__file__}", flush=True)
    launchers = _launchers(ops)
    pipe = WanPipeline.create(model=args.model,
                              attention_type=args.attention_type,
                              quant_linear=args.quant_linear, seed=0,
                              sla_topk=args.sla_topk, v_quant=args.v_quant,
                              sla_block=args.sla_block, device="cuda")
    denoise, decode = [], []
    for r in range(args.requests):
        gen = GenerationConfig(num_steps=4, num_frames=81,
                               resolution=args.resolution,
                               aspect_ratio="16:9", seed=r)
        for fn in launchers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        video = pipe.generate_t2v("a red fox running through snow", gen,
                                  timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        counts = {n: fn.launches for n, fn in launchers.items() if fn.launches}
        denoise.append(timings["denoise_ms"])
        decode.append(timings["vae_decode_ms"])
        peak = timings.get("peak_gib", torch.cuda.max_memory_allocated() / 2**30)
        phases = "".join(
            f" | {ph} peak {timings[f'{ph}_peak_gib']:.2f} GiB from "
            f"{timings[f'{ph}_start_gib']:.2f}"
            for ph in ("text_encode", "denoise", "vae_decode")
            if f"{ph}_peak_gib" in timings)
        print(f"{args.label} request {r}: text-encode "
              f"{timings['text_encode_ms']:.1f} ms | denoise "
              f"{timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{peak:.2f} GiB{phases} | video {tuple(video.shape)} | "
              f"launches {counts}", flush=True)
    print(json.dumps({"label": args.label, "denoise_ms": denoise,
                      "vae_decode_ms": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
