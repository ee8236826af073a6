"""Device memory and time of the port's VAE decode, by decoder stage.

Usage:
  python tools/vae_memory.py [--resolution 480p|720p] [--frames 81]
      [--chunk 4] [--root DIR]

Decodes one seeded random latent of a `--frames` request (16 x 21 x 60 x
104 at 480p/81f) with the seeded random Wan VAE decoder (`init_vae_params`,
seed 3) on the card, as `WanPipeline.generate_t2v` does (`vae_decode`, latent
frame 0 alone, then `--chunk` latent frames a step). It prints:
  * one line per decoder layer (the middle blocks, each block of the
    upsampling stages): the largest rise of
    `torch.cuda.max_memory_allocated` above the allocation at the layer's
    start over all chunks, its output shape on the last chunk, and its time
    summed over the chunks (CUDA events around the layer);
  * one line per distinct 3D conv shape (conv1 and the head's among them):
    its largest rise (the conv's output and its algorithm's workspace;
    for this decode only, `F.conv3d` is wrapped, and restored after);
  * the decode's own peak (the rise above the allocation when `vae_decode`
    starts) and its time, then one JSON line with both.
`--root DIR` imports the package from the checkout at DIR (an older commit
unpacked beside this one), so two trees are measured by one script.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", default="480p")
    p.add_argument("--aspect_ratio", default="16:9")
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--root", default=None,
                   help="checkout to import turbodiffusion_tpu_torch from")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    # the package of --root, else of the checkout this script lies in
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[1]))

    import torch
    import torch.nn.functional as F
    from turbodiffusion_tpu_torch.config import GenerationConfig
    from turbodiffusion_tpu_torch.models import vae as vae_mod
    from turbodiffusion_tpu_torch.pipelines.sampler import latent_shape

    if not torch.cuda.is_available():
        raise SystemExit("vae_memory: needs a CUDA card")
    gib = 2.0 ** 30
    print(f"{args.label} package {vae_mod.__file__}", flush=True)
    vae = vae_mod.init_vae_params(vae_mod.VAEConfig(), seed=3, device="cuda")
    gen = GenerationConfig(num_frames=args.frames, resolution=args.resolution,
                           aspect_ratio=args.aspect_ratio)
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((1, *latent_shape(gen)), generator=g, device="cuda")

    # decoder layers: forward hooks on each module the decoder calls
    dec = vae.decoder
    layers = [(f"middle.{i} {type(m).__name__}", m)
              for i, m in enumerate(dec.middle)]
    layers += [(f"upsamples.{i} {type(m).__name__}", m)
               for i, m in enumerate(dec.upsamples)]
    stats = {}
    # the peak a nested reset (a watched conv inside a layer) took away
    carry = [0]

    def pre(name):
        def hook(_mod, _inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stats.setdefault(name, {"rise": 0, "ms": 0.0, "shape": None})
            stats[name]["start"] = (torch.cuda.memory_allocated(), ev)
            torch.cuda.reset_peak_memory_stats()
            carry[0] = 0
        return hook

    def post(name):
        def hook(_mod, _inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            s = stats[name]
            start, ev0 = s.pop("start")
            peak = max(carry[0], torch.cuda.max_memory_allocated())
            s["rise"] = max(s["rise"], peak - start)
            s["ms"] += ev0.elapsed_time(ev)
            s["shape"] = tuple(out.shape)
        return hook

    # every 3D conv the decode runs: its own rise (output + workspace)
    conv3d = F.conv3d
    convs = {}

    def watched_conv3d(x, w, *a, **kw):
        carry[0] = max(carry[0], torch.cuda.max_memory_allocated())
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = conv3d(x, w, *a, **kw)
        key = (tuple(x.shape), tuple(w.shape))
        convs[key] = max(convs.get(key, 0),
                         torch.cuda.max_memory_allocated() - start)
        return out

    def decode():
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = vae_mod.vae_decode(vae, z, chunk=args.chunk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rise = torch.cuda.max_memory_allocated() - start
        if not bool(torch.isfinite(video).all()):
            raise AssertionError("non-finite video")
        return video, ms, rise

    decode()                                   # warm up (cuDNN's choices)
    video, ms, rise = decode()                 # the decode's own peak
    print(f"{args.label} decode {args.resolution} {args.frames}f chunk "
          f"{args.chunk}: video {tuple(video.shape)} | {ms:.1f} ms | own peak "
          f"{rise / gib:.2f} GiB above {torch.cuda.memory_allocated() / gib:.2f} "
          f"GiB allocated", flush=True)
    del video
    # the breakdown: a third decode with every layer and conv watched (the
    # hooks synchronise, so its times are per layer, not the decode's)
    for name, m in layers:
        m.register_forward_pre_hook(pre(name))
        m.register_forward_hook(post(name))
    F.conv3d = watched_conv3d      # vae.py calls it as F.conv3d
    try:
        decode()
    finally:
        F.conv3d = conv3d
    for name, s in stats.items():
        print(f"{args.label} layer {name}: out {s['shape']} | peak rise "
              f"{s['rise'] / gib:.2f} GiB | {s['ms']:.1f} ms", flush=True)
    for (xs, ws), r in sorted(convs.items(), key=lambda kv: -kv[1]):
        print(f"{args.label} conv3d x {xs} w {ws}: peak rise {r / gib:.2f} GiB",
              flush=True)
    print(json.dumps({"label": args.label, "resolution": args.resolution,
                      "frames": args.frames, "chunk": args.chunk,
                      "decode_ms": ms, "decode_own_peak_gib": rise / gib}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
