"""Time 480p/81f T2V requests of the port's Wan2.1-1.3B on the card.

Usage:
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --attention_type \
      sagesla --quant_linear --sla_topk 0.3 --requests 3 [--root DIR]

Builds `WanPipeline.create` with seeded random weights, runs `--requests`
4-step requests of seeds 0, 1, ... and prints a line for each: the
pipeline's text-encode, denoise and VAE-decode times (CUDA events), the
peak memory and the launches of every kernel launcher found in
`turbodiffusion_tpu_torch.ops` (each function with a `.launches` count),
by launcher name. `--root DIR` imports the package from the checkout at DIR
instead (an older commit unpacked beside this one, say), so that two trees
are timed by the same script on one card, one process each. The last line
is a JSON object with the denoise times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
import time


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
    p.add_argument("--attention_type", default="sagesla")
    p.add_argument("--sla_topk", type=float, default=0.1)
    p.add_argument("--quant_linear", action="store_true")
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)

    import torch
    from turbodiffusion_tpu_torch import ops
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline

    print(f"{args.label} package {ops.__file__}", flush=True)
    launchers = _launchers(ops)
    pipe = WanPipeline.create(model="Wan2.1-1.3B",
                              attention_type=args.attention_type,
                              quant_linear=args.quant_linear, seed=0,
                              sla_topk=args.sla_topk, device="cuda")
    denoise = []
    for r in range(args.requests):
        gen = GenerationConfig(num_steps=4, num_frames=81, resolution="480p",
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
        print(f"{args.label} request {r}: text-encode "
              f"{timings['text_encode_ms']:.1f} ms | denoise "
              f"{timings['denoise_ms']:.1f} ms | vae-decode "
              f"{timings['vae_decode_ms']:.1f} ms | wall {wall:.2f} s | peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
              f"launches {counts}", flush=True)
    print(json.dumps({"label": args.label, "denoise_ms": denoise}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
