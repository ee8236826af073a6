"""Checkpoint conversion and quantisation CLIs of the PyTorch port.

Ports `turbodiffusion_tpu/scripts/convert.py`:
  * quantize           — offline W8A8 quantisation of a DiT checkpoint,
                         `--mode block` (the reference's Int8Linear layout,
                         128x128 block scales; run by K22) or `postscale`;
                         Q / K / V stay separate on disk (:45-65);
  * merge              — task-arithmetic model merging (:133-152);
  * safetensors-to-pth — HF shards -> one state dict (:155-166).
`ckpt-to-pth` and `dcp-to-pth` read the JAX trainer's Orbax and the
reference's DCP checkpoints (the port's trainer writes `torch.save` files
of its own) and wait for ROADMAP Queue A item 11b.

Usage:
  python -m turbodiffusion_tpu_torch.scripts.convert quantize \
      --model Wan2.1-1.3B --input_path in.pth --output_path out.pth \
      --attention_type sagesla --quant_linear --mode block
"""

from __future__ import annotations

import argparse
import glob

import torch

_NOT_YET = ("reads Orbax / DCP trainer checkpoints: waits for ROADMAP Queue A "
            "item 11b")


def save_state_dict(sd: dict, path: str):
    """Save a state dict as .pth with the reference's dtype rules
    (convert.py:27-42): fp32 tensors go to bf16, except `*scale` keys;
    int8 and other dtypes stay. (JAX's `.npz` output is not ported.)"""
    torch.save({k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                    and not k.endswith("scale") else v).detach().cpu()
                for k, v in sd.items()}, path)


def cmd_quantize(args):
    from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
    from turbodiffusion_tpu_torch.pipelines.pipeline import make_wan_cfg
    from turbodiffusion_tpu_torch.utils.checkpoint import (
        load_torch_state_dict, strip_prefix, wan_params_from_state_dict,
        wan_state_dict_from_params)
    cfg = make_wan_cfg(args.model, args.attention_type, args.sla_topk,
                       quant_linear=args.quant_linear)
    model = wan_params_from_state_dict(
        strip_prefix(load_torch_state_dict(args.input_path)), cfg, args.device)
    if args.quant_linear:
        # the reference's per-linear Int8Linear layout: no QKV fusion on disk
        quantize_wan_blocks(model.blocks, mode=args.mode, fuse_qkv=False)
    out = wan_state_dict_from_params(model, cfg)
    save_state_dict(out, args.output_path)
    print(f"wrote {args.output_path} ({len(out)} tensors)")


def cmd_merge(args):
    """base + weight * (target - diff_base) (merge_models.py:6-60)."""
    from turbodiffusion_tpu_torch.utils.checkpoint import (
        load_torch_state_dict, merge_models)
    out = merge_models(load_torch_state_dict(args.base),
                       load_torch_state_dict(args.target),
                       load_torch_state_dict(args.diff_base), args.weight)
    save_state_dict(out, args.output_path)
    print(f"wrote {args.output_path} ({len(out)} tensors)")


def cmd_safetensors_to_pth(args):
    """HF safetensors shards -> one .pth; the Conv3d patch embedding is
    flattened to a Linear's (D, C*kt*kh*kw) (safetensors_to_pth.py:40-43)."""
    from turbodiffusion_tpu_torch.utils.checkpoint import load_torch_state_dict
    sd = {}
    for path in sorted(glob.glob(args.input_glob)):
        sd.update(load_torch_state_dict(path))
    w = sd.get("patch_embedding.weight")
    if w is not None and w.dim() == 5:
        sd["patch_embedding.weight"] = w.reshape(w.shape[0], -1)
    save_state_dict(sd, args.output_path)
    print(f"wrote {args.output_path} ({len(sd)} tensors)")


def _not_yet(args):
    raise NotImplementedError(f"{args.cmd} {_NOT_YET}")


def main(argv=None):
    p = argparse.ArgumentParser(description="TurboDiffusion (PyTorch) converters")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize")
    q.add_argument("--model", default="Wan2.1-1.3B")
    q.add_argument("--input_path", required=True)
    q.add_argument("--output_path", required=True)
    q.add_argument("--attention_type", default="original",
                   choices=["sla", "sagesla", "original"])
    q.add_argument("--sla_topk", type=float, default=0.2)
    q.add_argument("--quant_linear", action="store_true")
    q.add_argument("--mode", default="block", choices=["block", "postscale"])
    q.add_argument("--device", default="cuda",
                   help="torch device the model is built and quantised on")
    q.set_defaults(fn=cmd_quantize)

    for name in ("ckpt-to-pth", "dcp-to-pth"):
        sub.add_parser(name).set_defaults(fn=_not_yet)

    m = sub.add_parser("merge")
    m.add_argument("--base", required=True)
    m.add_argument("--target", required=True)
    m.add_argument("--diff_base", required=True)
    m.add_argument("--weight", type=float, default=1.0)
    m.add_argument("--output_path", required=True)
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("safetensors-to-pth")
    s.add_argument("--input_glob", required=True)
    s.add_argument("--output_path", required=True)
    s.set_defaults(fn=cmd_safetensors_to_pth)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
