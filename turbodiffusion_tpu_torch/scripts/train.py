"""Training CLI of the PyTorch port: SLA white-box fine-tuning and rCM
distillation.

The flag surface of `turbodiffusion_tpu/scripts/train.py:49-197`, plus
`--device` (default `cuda`; `cpu` runs the kernels' plain versions, for
small test models), `--time_phases` (synchronise after each phase of a
step and log its times: `sla` teacher / forward / backward / optimizer;
`rcm` see `training/distill.make_distill_steps`) and `--ckpt_dir ''` (no
checkpoints: a measurement run). Dotted `model.*` overrides apply to every
net alike, `trainer.*` to the TrainerConfig, `distill.*` (rcm) to the
DistillConfig.

`--experiment sla`: the sparse `sla` student (topk `--sla_topk`, blocks
512/256 at the published sizes) starts from the teacher's weights and
regresses the frozen dense (`original`) teacher's velocity. It keeps its
linear branch even where every `proj_l` is zero, as JAX does (it discards
`load_dit`'s config, which switches the branch off then): proj_l is the
main trainable and must receive gradients.

`--experiment rcm` (train.py:149-161): the `original` config plus the
`model.*` overrides (`model.attention.backend=sla` makes all three nets
sla, topk 0.1, blocks 512/256), the teacher loaded from --teacher_ckpt,
student and fake score initialised from it (`training/distill.py`); each
iteration is a student (sCM or dCM + DMD, then the EMA) or a critic
iteration by `distill.student_update_freq`.

Usage:
  python -m turbodiffusion_tpu_torch.scripts.train --experiment sla \
      --data 'shards/*.tar' --teacher_ckpt teacher.pth --model Wan2.1-1.3B \
      --remat block_wise -- trainer.max_iter=1000 trainer.save_every=100
  python -m turbodiffusion_tpu_torch.scripts.train --experiment rcm \
      --data 'shards/*.tar' --teacher_ckpt teacher.pth --model Wan2.1-1.3B \
      --remat block_wise -- distill.student_update_freq=5
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import sys

from turbodiffusion_tpu_torch.config import REMAT_LATER, REMAT_MODES


def apply_dotted_overrides(obj, overrides):
    """key=value dotted overrides onto (possibly nested, possibly frozen)
    dataclasses (scripts/train.py:21-45)."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        parts = key.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        cur = getattr(target, parts[-1])
        typ = type(cur) if cur is not None else str
        val = (raw.lower() == "true") if typ is bool else typ(raw)
        if dataclasses.is_dataclass(target):
            obj = _replace_path(obj, parts, val)
        else:
            setattr(target, parts[-1], val)
    return obj


def _replace_path(obj, parts, val):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: val})
    child = getattr(obj, parts[0])
    return dataclasses.replace(
        obj, **{parts[0]: _replace_path(child, parts[1:], val)})


def parse_arguments(argv):
    p = argparse.ArgumentParser(description="TurboDiffusion (PyTorch) training")
    p.add_argument("--experiment", choices=["sla", "rcm"], required=True)
    p.add_argument("--model", default="Wan2.1-1.3B")
    p.add_argument("--data", required=True, help="glob of tar shards")
    p.add_argument("--teacher_ckpt", default=None)
    p.add_argument("--ckpt_dir", default="checkpoints/run",
                   help="checkpoint directory; '' saves none and resumes "
                        "from none")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_iter", type=int, default=10000)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--sla_topk", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics_jsonl", default=None)
    p.add_argument("--mesh", type=str, default=None, metavar="DP,FSDP,CP",
                   help="multi-GPU mesh (not ported: ROADMAP Queue A item 12)")
    p.add_argument("--remat", default="none",
                   choices=list(REMAT_MODES + REMAT_LATER),
                   help="activation checkpointing: none, or block_wise / full "
                        "(each block recomputed in the backward); the "
                        "selective modes are not ported")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--time_phases", action="store_true",
                   help="synchronise after each phase of a step and report "
                        "its times in the metrics")
    return p.parse_args(argv)


def _with_cfg(model, cfg):
    """Give every module of `model` that carries a config `cfg`."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg
    return model


def main(argv=None, callbacks=()):
    """Run the CLI; `callbacks` are added to the trainer's. Returns the
    final TrainState (sla) or DistillState (rcm)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = []
    if "--" in argv:
        idx = argv.index("--")
        argv, overrides = argv[:idx], argv[idx + 1:]
    args = parse_arguments(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh (multi-GPU) waits for ROADMAP Queue A item 12")

    import torch

    from turbodiffusion_tpu_torch.pipelines.pipeline import load_dit, make_wan_cfg
    from turbodiffusion_tpu_torch.training import distill as D
    from turbodiffusion_tpu_torch.training.checkpointing import Checkpointer
    from turbodiffusion_tpu_torch.training.data import WebDatasetLoader
    from turbodiffusion_tpu_torch.training.train_step import (
        TrainState, make_optimizer, make_sla_train_step)
    from turbodiffusion_tpu_torch.training.trainer import (
        IterSpeed, JsonlLogger, Trainer, TrainerConfig)

    def prefixed(prefix):
        return [o[len(prefix):] for o in overrides if o.startswith(prefix)]

    model_ovr = prefixed("model.")
    device = torch.device(args.device)
    optimizer = make_optimizer(lr=args.lr)
    tcfg = TrainerConfig(max_iter=args.max_iter, save_every=args.save_every)
    tcfg = apply_dotted_overrides(tcfg, prefixed("trainer."))
    if args.experiment == "sla":
        cfg = make_wan_cfg(args.model, attention_type="sla",
                           sla_topk=args.sla_topk)
        cfg_teacher = make_wan_cfg(args.model, attention_type="original")
        cfg = apply_dotted_overrides(cfg, model_ovr).replace(remat=args.remat)
        cfg_teacher = apply_dotted_overrides(cfg_teacher, model_ovr).replace(
            remat=args.remat)
        # the student starts FROM the teacher's weights, the teacher stays
        # frozen with dense attention (t2v_model_sla.py); the student keeps
        # cfg (its linear branch on), whatever load_dit makes of a zero
        # proj_l
        student = _with_cfg(load_dit(args.teacher_ckpt, cfg, args.seed,
                                     device)[0], cfg)
        teacher = load_dit(args.teacher_ckpt, cfg_teacher, args.seed, device)[0]
        teacher.eval().requires_grad_(False)
        state = TrainState(student, optimizer.init(student), 0)
        step = make_sla_train_step(teacher, optimizer,
                                   time_phases=args.time_phases)
    else:
        cfg = make_wan_cfg(args.model, attention_type="original")
        cfg = apply_dotted_overrides(cfg, model_ovr).replace(remat=args.remat)
        dcfg = apply_dotted_overrides(D.DistillConfig(), prefixed("distill."))
        # all three nets keep cfg, whatever load_dit makes of a zero proj_l
        teacher = _with_cfg(load_dit(args.teacher_ckpt, cfg, args.seed,
                                     device)[0], cfg)
        state = D.create_distill_state(teacher, optimizer, dcfg)
        step = D.make_distill_steps(dcfg, optimizer,
                                    time_phases=args.time_phases)

    loader = WebDatasetLoader(sorted(glob.glob(args.data)), args.batch_size,
                              seed=args.seed, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    restored, at = ckpt.restore(state, generator=generator) if ckpt else (None, None)
    if restored is not None:
        state, start = restored, at
        print(f"resumed from iteration {at}", flush=True)

    cbs = [IterSpeed(tcfg.log_every)]
    if args.metrics_jsonl:
        cbs.append(JsonlLogger(args.metrics_jsonl))
    trainer = Trainer(tcfg, step, checkpointer=ckpt, callbacks=cbs + list(callbacks))
    return trainer.train(state, loader, generator, start_iter=start)


if __name__ == "__main__":
    main()
