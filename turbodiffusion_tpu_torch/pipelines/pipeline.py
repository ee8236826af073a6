"""Resident T2V pipeline.

Ports `turbodiffusion_tpu/pipelines/pipeline.py`: `make_wan_cfg` and
`load_dit` (:41-104: random weights or a checkpoint, the W8A8 rules and the
zero-`proj_l` rule), `TextEncoder` (:107-160: random or checkpoint weights,
and the hash-tokenizer fallback, refused with real weights) and
`WanPipeline.create` (with `dit_path`, `vae_path`, `text_encoder_path`) /
`generate_t2v` (:185-288). Checkpoints are read by `utils/checkpoint.py`.
The models stay resident on the pipeline's device and answer any number of
requests; every entry point runs on the card unless told otherwise.
Wan2.1-1.3B and Wan2.1-14B run on the card in every form the JAX package
gives them: bf16, W8A8 postscale (`--quant_linear`) or 128x128 block-scaled
linears, with `sagesla`, `sla` or `original` attention, at 480p and 720p.
I2V and meshes wait for later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from turbodiffusion_tpu_torch.config import (
    AttentionConfig, GenerationConfig, WanConfig,
    wan_config, wan_test_config)
from turbodiffusion_tpu_torch.models.umt5 import (
    UMT5Config, UMT5Encoder, init_umt5_params, tokenize, umt5_embed_padded,
    umt5_test_config)
from turbodiffusion_tpu_torch.models.vae import (
    VAEConfig, WanVAE, init_vae_params, vae_decode)
from turbodiffusion_tpu_torch.models.wan import WanModel, init_wan_params
from turbodiffusion_tpu_torch.ops.quant import (
    Int8BlockLinear, quantize_wan_blocks)
from turbodiffusion_tpu_torch.utils.checkpoint import (
    load_torch_state_dict, strip_prefix,
    umt5_params_from_state_dict, vae_params_from_state_dict,
    wan_params_from_state_dict)
from turbodiffusion_tpu_torch.pipelines.sampler import latent_shape, rcm_sample

log = logging.getLogger(__name__)


def make_wan_cfg(model: str, attention_type: str = "sagesla",
                 sla_topk: float = 0.1, quant_linear: bool = False,
                 sla_block: int = 256, v_quant: str = "channel") -> WanConfig:
    """A WanConfig from the CLI flag surface (pipeline.py:41-63): block_q is
    twice the K-block granularity at 256 and above (512/256), equal below
    (64/64 and 128/128, the parity blocks of reference-trained SLA maps);
    v_quant is sagesla's INT8 V granularity ("channel" or "row");
    quant_linear selects the W8A8 postscale linears."""
    backend = attention_type if attention_type in ("sla", "sagesla") else "dense"
    blk = 8 if model == "test" else sla_block
    bq = min(2 * blk, 512) if blk >= 256 else blk
    attn = AttentionConfig(backend=backend, sla_topk=sla_topk, block_q=bq,
                           block_k=blk, v_quant=v_quant)
    if model == "test":
        return wan_test_config(attention=attn, quant_linear=quant_linear)
    return wan_config(model, attention=attn, quant_linear=quant_linear)


def load_dit(dit_path, cfg: WanConfig, seed: int = 0, device="cuda"):
    """The DiT on `device` (pipeline.py:66-104): random weights
    (dit_path=None), or a reference checkpoint (a path, or its state dict
    already loaded), each linear in its layout on disk. With
    `cfg.quant_linear`, float linears become W8A8 postscale and postscale
    Q / K / V are fused below dim 4096, as JAX does; a block-scaled
    checkpoint is left as it is. Returns (model, cfg); cfg turns the linear
    branch off when every proj_l is exactly zero."""
    if dit_path is None:
        model = init_wan_params(cfg, seed, device)
    else:
        sd = (dit_path if isinstance(dit_path, dict)
              else strip_prefix(load_torch_state_dict(dit_path)))
        model = wan_params_from_state_dict(sd, cfg, device)
    if cfg.quant_linear and not isinstance(model.blocks[0].self_attn.q,
                                           Int8BlockLinear):
        quantize_wan_blocks(model.blocks, mode="postscale",
                            fuse_qkv=cfg.dim < 4096)
    projs = [b.self_attn.proj_l for b in model.blocks
             if b.self_attn.proj_l is not None]
    if projs and cfg.attention.backend in ("sla", "sagesla"):
        zero = all(not p.weight.detach().any() and not p.bias.detach().any()
                   for p in projs)
        if zero:
            cfg = cfg.replace(attention=dataclasses.replace(
                cfg.attention, linear_branch=False))
            for m in model.modules():
                if hasattr(m, "cfg"):
                    m.cfg = cfg
    return model, cfg


class TextEncoder:
    """umT5 embedding service (pipeline.py:107-160). Built lazily on
    `device`, from the reference's encoder checkpoint or, without one, from
    random weights; `free` releases it. Prompts are tokenised from a local
    umT5 tokenizer directory (`tokenizer_path`). Without one (or without
    `transformers`) random weights take a hash tokenizer, and real weights
    refuse it, as JAX does (:129-143), unless TDX_ALLOW_HASH_TOKENIZER=1."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 text_len: int = 512, cfg: Optional[UMT5Config] = None,
                 device="cuda", tokenizer_path: Optional[str] = None):
        self.cfg = cfg if cfg is not None else UMT5Config(text_len=text_len)
        self.checkpoint_path = checkpoint_path
        self.device = torch.device(device)
        self.tokenizer_path = tokenizer_path
        self.encoder: Optional[UMT5Encoder] = None

    def load(self):
        if self.encoder is None:
            if self.checkpoint_path is None:
                self.encoder = init_umt5_params(self.cfg, seed=7,
                                                device=self.device)
            else:
                self.encoder = umt5_params_from_state_dict(
                    load_torch_state_dict(self.checkpoint_path), self.cfg,
                    self.device)
        return self

    def _hash_tokens(self, prompts):
        """Deterministic ids for checkpoint-free runs: NOT a text encoding."""
        ids = np.zeros((len(prompts), self.cfg.text_len), np.int64)
        mask = np.zeros_like(ids)
        for b, p in enumerate(prompts):
            toks = [hash(w) % self.cfg.vocab_size for w in p.split()][
                : self.cfg.text_len]
            ids[b, :len(toks)] = toks
            mask[b, :len(toks)] = 1
        return torch.from_numpy(ids), torch.from_numpy(mask)

    @torch.no_grad()
    def __call__(self, prompts) -> torch.Tensor:
        self.load()
        if isinstance(prompts, str):
            prompts = [prompts]
        try:
            ids, mask = tokenize(prompts, self.cfg.text_len,
                                 self.tokenizer_path)
        except (ImportError, OSError) as e:
            # the hash fallback keeps checkpoint-free runs deterministic; with
            # real encoder weights it would silently ruin every request
            if (self.checkpoint_path is not None
                    and os.environ.get("TDX_ALLOW_HASH_TOKENIZER") != "1"):
                raise RuntimeError(
                    "umT5 tokenizer unavailable but real encoder weights are "
                    "loaded — refusing the hash-tokenizer fallback (pass a "
                    "local umT5 tokenizer directory, or set "
                    "TDX_ALLOW_HASH_TOKENIZER=1 to force)") from e
            log.warning("umT5 tokenizer unavailable (%s); using the HASH "
                        "tokenizer fallback — embeddings are NOT meaningful "
                        "text encodings", e)
            ids, mask = self._hash_tokens(prompts)
        return umt5_embed_padded(self.encoder, ids.to(self.device),
                                 mask.to(self.device))

    def free(self):
        self.encoder = None


class _PhaseTimer:
    """Per-phase times in ms: CUDA events on a card, the host clock on the
    CPU. On a card it also keeps each phase's device memory: the allocation
    at its start and its peak (`max_memory_allocated`, reset at each phase's
    start). `stop` reads them (synchronising the events)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mem = []

    def mark(self, name):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
            if self.mem:
                self.mem[-1].append(torch.cuda.max_memory_allocated())
            self.mem.append([torch.cuda.memory_allocated()])
            torch.cuda.reset_peak_memory_stats()
        else:
            self.marks.append((name, time.perf_counter()))

    def stop(self, out: dict):
        self.mark(None)
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if self.cuda:
                b.synchronize()
                out[f"{name}_ms"] = a.elapsed_time(b)
            else:
                out[f"{name}_ms"] = (b - a) * 1e3
        if self.cuda:
            for (name, _), (start, peak) in zip(self.marks[:-1], self.mem):
                out[f"{name}_start_gib"] = start / 2**30
                out[f"{name}_peak_gib"] = peak / 2**30
            out["peak_gib"] = max(peak for _, peak in self.mem[:-1]) / 2**30


@dataclass(eq=False)
class WanPipeline:
    """Resident T2V pipeline (pipeline.py:163-288): DiT, VAE and text
    encoder held on `device` between requests."""

    cfg: WanConfig
    dit: WanModel
    vae: WanVAE
    text_encoder: TextEncoder
    device: torch.device

    @classmethod
    def create(cls, model: str = "Wan2.1-1.3B", dit_path=None,
               vae_path: Optional[str] = None,
               text_encoder_path: Optional[str] = None,
               attention_type: str = "sagesla", sla_topk: float = 0.1,
               quant_linear: bool = False, seed: int = 0,
               sla_block: int = 256, v_quant: str = "channel",
               tokenizer_path: Optional[str] = None, device="cuda"):
        """The pipeline on `device`: each model from its checkpoint path
        where one is given (the VAE's is ignored at model "test", as in JAX,
        :204-210), else random weights: DiT from `seed`, VAE from 3, umT5
        from 7, as the JAX package seeds them. `dit_path` may also be a DiT
        state dict already in memory (`load_dit`)."""
        device = torch.device(device)
        cfg = make_wan_cfg(model, attention_type, sla_topk, quant_linear,
                           sla_block=sla_block, v_quant=v_quant)
        dit, cfg = load_dit(dit_path, cfg, seed, device)
        if model == "test":
            te = TextEncoder(text_encoder_path, cfg=umt5_test_config(
                dim=cfg.text_dim, text_len=cfg.text_len), device=device,
                tokenizer_path=tokenizer_path)
            vae = init_vae_params(VAEConfig(dim=16, dtype=torch.float32),
                                  seed=3, device=device)
        else:
            te = TextEncoder(text_encoder_path, device=device,
                             tokenizer_path=tokenizer_path)
            vae = (init_vae_params(VAEConfig(), seed=3, device=device)
                   if vae_path is None else vae_params_from_state_dict(
                       load_torch_state_dict(vae_path), VAEConfig(), device))
        return cls(cfg=cfg, dit=dit, vae=vae, text_encoder=te, device=device)

    @torch.no_grad()
    def generate_t2v(self, prompt: str,
                     gen: GenerationConfig = GenerationConfig(),
                     text_emb: Optional[torch.Tensor] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noises=None,
                     timings: Optional[dict] = None) -> torch.Tensor:
        """T2V generation (pipeline.py:258-288): text encode, the rCM loop
        over the DiT, VAE decode. Returns (B, 3, T, H, W) fp32 in [0, 1] on
        the pipeline's device.

        The noise comes from a torch.Generator seeded with `gen.seed` on the
        device unless `init_noise` (B, 16, T_lat, H/8, W/8) and
        `step_noises` (one tensor per step) give it. A `timings` dict
        receives text_encode_ms, denoise_ms and vae_decode_ms and, on a
        card, each phase's device memory at its start and its peak
        (`<phase>_start_gib`, `<phase>_peak_gib`) and the request's
        `peak_gib`. To read them it calls
        `torch.cuda.reset_peak_memory_stats()` at each phase's start, so
        with `timings` the process-wide `max_memory_allocated` no longer
        holds any peak from before the call; afterwards it holds the
        decode's.
        """
        timer = _PhaseTimer(self.device) if timings is not None else None
        mark = timer.mark if timer else (lambda name: None)
        mark("text_encode")
        if text_emb is None:
            text_emb = self.text_encoder(prompt)
        text_emb = text_emb.to(self.device, self.cfg.dtype).repeat_interleave(
            gen.num_samples, dim=0)
        mark("denoise")
        g = torch.Generator(device=self.device).manual_seed(gen.seed)
        if init_noise is None:
            init_noise = torch.randn(
                (gen.num_samples, *latent_shape(gen)), generator=g,
                device=self.device, dtype=torch.float32)

        def denoise_fn(x, t_cur, i):
            tt = torch.full((x.shape[0], 1), float(t_cur * np.float32(1000.0)),
                            dtype=torch.float32, device=self.device)
            return self.dit(x, tt, text_emb)

        x = rcm_sample(denoise_fn, init_noise.to(self.device), gen.num_steps,
                       gen.sigma_max, gen.mid_t, gen.ode, generator=g,
                       step_noises=step_noises)
        mark("vae_decode")
        chunk = 4 if (x.shape[2] - 1) % 4 == 0 else 1
        video = vae_decode(self.vae, x, chunk=chunk)
        video = (1.0 + video.clamp(-1.0, 1.0)) / 2.0
        if timer:
            timer.stop(timings)
        return video
