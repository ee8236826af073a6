"""Time 81-frame T2V requests of the port's Wan2.1 models on the card.

Usage:
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --attention_type \
      sagesla --quant_linear --sla_topk 0.3 --requests 3 [--root DIR]
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --model Wan2.1-14B \
      --resolution 720p --requests 2
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --model Wan2.1-14B \
      --block_scale --requests 2
  python turbodiffusion_tpu_torch/scripts/time_t2v.py --quant_linear \
      --linear_branch --requests 2
  (also --v_quant row, --sla_block 64: the CLI's flags)

Builds `WanPipeline.create` with seeded random weights, runs `--requests`
4-step requests of seeds 0, 1, ... and prints a line for each: the
pipeline's text-encode, denoise and VAE-decode times (CUDA events), the
request's peak memory, each phase's peak and the allocation at its start
(where the package's pipeline reports them), and the launches of every
kernel launcher found in
`turbodiffusion_tpu_torch.ops` (each function with a `.launches` count),
by launcher name. `--block_scale` loads a seeded random DiT whose block
linears are quantised to 128 x 128 block scales on the card, passed to
`create` as a state dict (`dit_path`), as a `-quant` checkpoint loads: the
block-scale path (the activation quantiser and K22 in every linear).
`--linear_branch` gives every block's `proj_l` seeded non-zero random
weights in that state dict (with or without `--block_scale`), so `create`
keeps the SLA linear branch on, as it does for a trained checkpoint
(random weights leave `proj_l` zero, and `load_dit` then turns the branch
off), as JAX's bench builds its config (`bench.py:64-79`): K6's kv sums and
K7's linear epilogue on the fused path. `main(argv, after)` calls
`after(pipe, args)` once the requests are done (`tools/profile_t2v.py`
profiles a DiT call there).
`--root DIR` imports the package from the checkout at DIR
instead (an older commit unpacked beside this one, say), so that two trees
are timed by the same script on one card, one process each. The last line
is a JSON object with the denoise and VAE-decode times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
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


def _dit_state(args, seed: int = 11):
    """With `--block_scale` or `--linear_branch`, a seeded random DiT of the
    model's widths as the reference-named state dict a checkpoint holds:
    `--linear_branch` gives every block's proj_l N(0, 0.3^2 / fan_in)
    weights and N(0, 0.1^2) biases, `--block_scale` then quantises every
    block linear to 128 x 128 block scales on the card (a `-quant`
    checkpoint). The weights are those `create` draws (seed 0), or seed 13
    with `--block_scale`. None without either flag."""
    if not (args.block_scale or args.linear_branch):
        return None
    import torch
    from turbodiffusion_tpu_torch.models.wan import init_wan_params
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
    from turbodiffusion_tpu_torch.utils.checkpoint import wan_state_dict_from_params
    cfg = make_wan_cfg(args.model, args.attention_type, args.sla_topk)
    model = init_wan_params(cfg, seed=13 if args.block_scale else 0, device="cuda")
    if args.linear_branch:
        g = torch.Generator(device="cuda").manual_seed(seed)
        with torch.no_grad():
            for blk in model.blocks:
                p = blk.self_attn.proj_l
                p.weight.copy_(torch.randn(p.weight.shape, generator=g, device="cuda")
                               * (0.3 / math.sqrt(p.in_features)))
                p.bias.copy_(torch.randn(p.bias.shape, generator=g, device="cuda") * 0.1)
    if args.block_scale:
        quantize_wan_blocks(model.blocks, mode="block", fuse_qkv=False)
    return wan_state_dict_from_params(model, cfg)


def main(argv=None, after=None) -> int:
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
    p.add_argument("--block_scale", action="store_true",
                   help="block linears with 128 x 128 block scales (K22)")
    p.add_argument("--linear_branch", action="store_true",
                   help="non-zero proj_l in every block: the SLA linear branch on")
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
    dit = _dit_state(args)
    pipe = WanPipeline.create(model=args.model,
                              attention_type=args.attention_type,
                              quant_linear=args.quant_linear, seed=0,
                              sla_topk=args.sla_topk, v_quant=args.v_quant,
                              sla_block=args.sla_block, device="cuda",
                              dit_path=dit)
    del dit
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
    if after is not None:
        after(pipe, args)
    print(json.dumps({"label": args.label, "denoise_ms": denoise,
                      "vae_decode_ms": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
