"""Wan2.1 T2V inference CLI of the PyTorch port.

The flag surface of `turbodiffusion_tpu/inference/wan2_1_t2v.py:19-63`,
plus `--device` (default `cuda`; `cpu` runs the plain versions of the
kernels, for small test models). Flags whose paths are not ported yet raise
NotImplementedError naming their ROADMAP item.

Usage:
  python -m turbodiffusion_tpu_torch.inference.wan2_1_t2v --random_weights \
      --prompt "..." [--attention_type sagesla|sla|original] [--quant_linear]
      [--v_quant channel|row] [--sla_block 64|128|256] [--num_steps 4]
  python -m turbodiffusion_tpu_torch.inference.wan2_1_t2v --random_weights \
      --model Wan2.1-14B --quant_linear --prompt "..."   # W8A8 sagesla only
"""

from __future__ import annotations

import argparse
import time

from einops import rearrange

_NOT_YET = {
    "serve": "the serve TUI waits for ROADMAP Queue A item 14",
    "mesh": "multi-GPU meshes wait for ROADMAP Queue A item 12",
    "dit_path": "checkpoint loading waits for ROADMAP Queue A item 14",
}


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="TurboDiffusion (PyTorch) inference script for Wan2.1 T2V")
    p.add_argument("--dit_path", type=str, default=None,
                   help="Path to the DiT checkpoint (distilled model)")
    p.add_argument("--model", choices=["Wan2.1-1.3B", "Wan2.1-14B", "test"],
                   default="Wan2.1-1.3B")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--num_steps", type=int, choices=[1, 2, 3, 4], default=4,
                   help="1~4 for timestep-distilled inference")
    p.add_argument("--sigma_max", type=float, default=80,
                   help="Initial sigma for rCM")
    p.add_argument("--vae_path", type=str, default=None,
                   help="Path to the Wan2.1 VAE checkpoint")
    p.add_argument("--text_encoder_path", type=str, default=None,
                   help="Path to the umT5 text encoder checkpoint")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--resolution", default="480p", type=str)
    p.add_argument("--aspect_ratio", default="16:9", type=str)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str,
                   default="output/generated_video.mp4")
    p.add_argument("--attention_type", choices=["sla", "sagesla", "original"],
                   default="sagesla")
    p.add_argument("--sla_topk", type=float, default=0.1)
    p.add_argument("--sla_block", type=int, default=256,
                   choices=[64, 128, 256],
                   help="sparse block granularity (block_k; block_q is 512 "
                        "at 256)")
    p.add_argument("--v_quant", choices=["channel", "row"], default="channel",
                   help="sagesla INT8 V granularity (sagesla only)")
    p.add_argument("--quant_linear", action="store_true",
                   help="W8A8 int8 linears in the transformer blocks")
    p.add_argument("--default_norm", action="store_true",
                   help="Kept for reference CLI parity (norms are fused)")
    p.add_argument("--serve", action="store_true",
                   help="Launch interactive TUI server mode")
    p.add_argument("--random_weights", action="store_true",
                   help="Run with random weights (no checkpoints)")
    p.add_argument("--mesh", type=str, default=None, metavar="DP,FSDP,CP",
                   help="Multi-GPU mesh")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    for flag, why in _NOT_YET.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: {why}")
    if args.prompt is None:
        raise SystemExit("--prompt is required")
    if not args.random_weights:
        raise SystemExit("--random_weights is required (checkpoint loading "
                         "is not ported yet)")

    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.pipelines.pipeline import (
        WanPipeline, check_ported)
    from turbodiffusion_tpu_torch.utils.video_io import save_video
    check_ported(args.model, args.attention_type, args.quant_linear,
                 args.device)

    pipe = WanPipeline.create(
        model=args.model, vae_path=args.vae_path,
        text_encoder_path=args.text_encoder_path,
        attention_type=args.attention_type, sla_topk=args.sla_topk,
        sla_block=args.sla_block, v_quant=args.v_quant,
        quant_linear=args.quant_linear, seed=args.seed, device=args.device)
    gen = GenerationConfig(
        num_steps=args.num_steps, sigma_max=args.sigma_max,
        num_frames=args.num_frames, resolution=args.resolution,
        aspect_ratio=args.aspect_ratio, seed=args.seed,
        num_samples=args.num_samples)

    print(f"Generating with prompt: {args.prompt}")
    t0 = time.time()
    video = pipe.generate_t2v(args.prompt, gen).cpu().numpy()
    print(f"Generated in {time.time() - t0:.2f}s")
    grid = rearrange(video, "b c t h w -> c t h (b w)")
    out = save_video(grid, args.save_path, fps=16)
    print(f"Saved to {out}")


if __name__ == "__main__":
    main()
