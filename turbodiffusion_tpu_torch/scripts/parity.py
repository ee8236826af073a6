"""Quality-parity harness of the PyTorch port: compare the port's generation
against dumped tensors, stage by stage.

Ports `turbodiffusion_tpu/scripts/parity.py`. The dump directory protocol
(:9-16) is framework-neutral, so the port's `replay` reads the JAX
package's dumps (and the reference's, hooked the same way):
    meta.json           {"model", "num_steps", "sigma_max", "ode",
                         "attention_type"}
    noise.npy           (B, 16, T, H, W)   initial latent noise
    text_emb.npy        (B, 512, text_dim) umT5 embedding (pre-DiT)
    latent_step_XXX.npy (B, 16, T, H, W)   latent AFTER denoise step XXX
    video.npy           (B, 3, F, Hp, Wp)  decoded frames in [0, 1]
all .npy, channel-first, fp32. `run_stages` replays the sampling loop from
the dumped noise and text embedding (:75-100); an SDE replay draws its
noise from a torch.Generator, so only ODE dumps (the JAX dump's) compare.

Usage:
  python -m turbodiffusion_tpu_torch.scripts.parity replay \
      --dump_dir golden/ --model Wan2.1-1.3B --dit_path ckpt.pth
  python -m turbodiffusion_tpu_torch.scripts.parity dump --out_dir golden/ \
      --model Wan2.1-1.3B --dit_path ckpt.pth

Reports per-stage MSE / PSNR / max|d|; exits non-zero if any stage falls
below --min_psnr (default 30 dB).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch


def _psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


def _report(name: str, ours: np.ndarray, ref: np.ndarray, peak: float):
    if ours.shape != ref.shape:
        print(f"  {name:<18} SHAPE MISMATCH ours={ours.shape} ref={ref.shape}")
        return -1.0
    mse = float(np.mean((ours.astype(np.float64) - ref) ** 2))
    psnr = _psnr(ours, ref, peak)
    mad = float(np.max(np.abs(ours.astype(np.float64) - ref)))
    print(f"  {name:<18} mse={mse:.3e}  psnr={psnr:7.2f} dB  max|d|={mad:.3e}")
    return psnr


def build_pipeline(args):
    from turbodiffusion_tpu_torch.pipelines.pipeline import WanPipeline
    if args.dit_path is None and not args.random_weights:
        print("note: no --dit_path; running with random weights "
              "(pass --random_weights to silence)", file=sys.stderr)
    return WanPipeline.create(
        model=args.model, dit_path=args.dit_path, vae_path=args.vae_path,
        text_encoder_path=args.text_encoder_path,
        attention_type=args.attention_type, sla_topk=args.sla_topk,
        quant_linear=args.quant_linear, seed=args.seed,
        tokenizer_path=args.tokenizer_path, device=args.device)


@torch.no_grad()
def run_stages(pipe, meta: dict, noise: np.ndarray, text_emb: np.ndarray):
    """The sampling loop from the dumped noise and text embedding, keeping
    the latent after every step, then the decoded video in [0, 1]
    (pipeline.generate_t2v's math)."""
    from turbodiffusion_tpu_torch.models.vae import vae_decode
    from turbodiffusion_tpu_torch.pipelines.sampler import rcm_sample
    dev = pipe.device
    te = torch.from_numpy(text_emb).to(dev, pipe.cfg.dtype)
    lats = []

    def denoise_fn(x, t_cur, i):
        if i:
            lats.append(x)
        tt = torch.full((x.shape[0], 1), float(t_cur * np.float32(1000.0)),
                        dtype=torch.float32, device=dev)
        return pipe.dit(x, tt, te)

    x = rcm_sample(denoise_fn, torch.from_numpy(noise).to(dev),
                   int(meta["num_steps"]), float(meta["sigma_max"]),
                   ode=bool(meta["ode"]),
                   generator=torch.Generator(device=dev).manual_seed(0))
    lats.append(x)
    chunk = 4 if (x.shape[2] - 1) % 4 == 0 else 1
    video = (1.0 + vae_decode(pipe.vae, x, chunk=chunk).clamp(-1.0, 1.0)) / 2.0
    return [t.cpu().numpy() for t in lats], video.cpu().numpy()


def replay(pipe, dump_dir: str) -> float:
    """Run `pipe` on a dump's noise and text embedding; print each stage's
    numbers against the dump and return the worst PSNR in dB."""
    with open(os.path.join(dump_dir, "meta.json")) as f:
        meta = json.load(f)
    lat, video = run_stages(pipe, meta,
                            np.load(os.path.join(dump_dir, "noise.npy")),
                            np.load(os.path.join(dump_dir, "text_emb.npy")))
    print(f"parity vs {dump_dir} (model={meta['model']}, "
          f"steps={meta['num_steps']}):")
    worst = float("inf")
    paths = sorted(glob.glob(os.path.join(dump_dir, "latent_step_*.npy")))
    for i, path in enumerate(paths[:len(lat)]):
        ref = np.load(path)
        worst = min(worst, _report(os.path.basename(path), lat[i], ref,
                                   float(np.max(np.abs(ref))) or 1.0))
    vid_path = os.path.join(dump_dir, "video.npy")
    if os.path.exists(vid_path):
        worst = min(worst, _report("video", video, np.load(vid_path), 1.0))
    return worst


def cmd_replay(args):
    worst = replay(build_pipeline(args), args.dump_dir)
    if worst < args.min_psnr:
        print(f"FAIL: worst stage {worst:.2f} dB < {args.min_psnr} dB")
        sys.exit(1)
    print(f"PASS: worst stage {worst:.2f} dB >= {args.min_psnr} dB")


def cmd_dump(args):
    """Golden dumps from the port (ODE sampling; noise from a
    torch.Generator seeded with --seed)."""
    from turbodiffusion_tpu_torch.config import VIDEO_RES_SIZE_INFO
    pipe = build_pipeline(args)
    os.makedirs(args.out_dir, exist_ok=True)
    w, h = VIDEO_RES_SIZE_INFO[args.resolution][args.aspect_ratio]
    g = torch.Generator(device=pipe.device).manual_seed(args.seed)
    noise = torch.randn((1, 16, 1 + (args.num_frames - 1) // 4, h // 8, w // 8),
                        generator=g, device=pipe.device).cpu().numpy()
    with torch.no_grad():
        text_emb = pipe.text_encoder(args.prompt).float().cpu().numpy()
    meta = {"model": args.model, "num_steps": args.num_steps,
            "sigma_max": args.sigma_max, "ode": True,
            "attention_type": args.attention_type}
    lat, video = run_stages(pipe, meta, noise, text_emb)
    np.save(os.path.join(args.out_dir, "noise.npy"), noise)
    np.save(os.path.join(args.out_dir, "text_emb.npy"), text_emb)
    for i, l in enumerate(lat):
        np.save(os.path.join(args.out_dir, f"latent_step_{i:03d}.npy"), l)
    np.save(os.path.join(args.out_dir, "video.npy"), video)
    with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"dumped {len(lat)} latent stages + video to {args.out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Quality-parity harness")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--model", default="Wan2.1-1.3B")
        sp.add_argument("--dit_path", default=None)
        sp.add_argument("--vae_path", default=None)
        sp.add_argument("--text_encoder_path", default=None)
        sp.add_argument("--tokenizer_path", default=None)
        sp.add_argument("--attention_type", default="original")
        sp.add_argument("--sla_topk", type=float, default=0.1)
        sp.add_argument("--quant_linear", action="store_true")
        sp.add_argument("--random_weights", action="store_true")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda")

    d = sub.add_parser("dump", help="generate golden dumps")
    common(d)
    d.add_argument("--out_dir", required=True)
    d.add_argument("--prompt", default="a red boat on a calm lake")
    d.add_argument("--num_steps", type=int, default=4)
    d.add_argument("--sigma_max", type=float, default=80.0)
    d.add_argument("--num_frames", type=int, default=81)
    d.add_argument("--resolution", default="480p")
    d.add_argument("--aspect_ratio", default="16:9")
    d.set_defaults(fn=cmd_dump)

    r = sub.add_parser("replay", help="compare against dumps")
    common(r)
    r.add_argument("--dump_dir", required=True)
    r.add_argument("--min_psnr", type=float, default=30.0)
    r.set_defaults(fn=cmd_replay)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
