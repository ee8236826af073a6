"""Resident T2V pipeline.

Ports `turbodiffusion_tpu/pipelines/pipeline.py`: `make_wan_cfg` and
`load_dit` (:41-104, with the zero-`proj_l` rule), `TextEncoder` with its
hash-tokenizer fallback (:107-160) and `WanPipeline.create` /
`generate_t2v` (:185-288). The models stay resident on the pipeline's
device and answer any number of requests; every entry point runs on the
card unless told otherwise. Wan2.1-14B runs on the card as W8A8 sagesla
(`check_ported`). I2V, meshes and checkpoint loading (`dit_path`,
`vae_path`, `text_encoder_path`) wait for later slices.
"""

from __future__ import annotations

import dataclasses
import logging
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
from turbodiffusion_tpu_torch.ops.quant import quantize_wan_blocks
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


def check_ported(model: str, attention_type: str, quant_linear: bool,
                 device) -> None:
    """Refuse a configuration the port's kernels do not carry on a card yet:
    Wan2.1-14B runs there only as sagesla with W8A8 linears. Its other
    configurations (bf16 linears, `sla`, `original`) need K2 (RMSNorm +
    RoPE) at dim 5120, the bf16 ones a ~26 GiB DiT (ROADMAP Queue A item
    15)."""
    if (model == "Wan2.1-14B" and torch.device(device).type == "cuda"
            and (attention_type != "sagesla" or not quant_linear)):
        raise NotImplementedError(
            "Wan2.1-14B runs on a card only with --attention_type sagesla and "
            "--quant_linear; bf16 14B and its sla / original attention wait "
            "for K2 at dim 5120 (ROADMAP Queue A item 15)")


def load_dit(dit_path: Optional[str], cfg: WanConfig, seed: int = 0,
             device="cuda"):
    """Random weights (dit_path=None) on `device` (pipeline.py:66-104),
    quantised to W8A8 postscale when `cfg.quant_linear` (QKV fused below
    dim 4096, as JAX does). Returns (model, cfg); cfg turns the linear
    branch off when every proj_l is exactly zero."""
    if dit_path is not None:
        raise NotImplementedError(
            "DiT checkpoint loading waits for checkpoint import (ROADMAP "
            "Queue A item 14)")
    model = init_wan_params(cfg, seed, device)
    if cfg.quant_linear:
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
    `device`; `free` releases it. Without a local tokenizer directory the
    prompts go through a hash tokenizer."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 text_len: int = 512, cfg: Optional[UMT5Config] = None,
                 device="cuda", tokenizer_path: Optional[str] = None):
        if checkpoint_path is not None:
            raise NotImplementedError(
                "umT5 checkpoint loading waits for checkpoint import (ROADMAP "
                "Queue A item 14)")
        self.cfg = cfg if cfg is not None else UMT5Config(text_len=text_len)
        self.device = torch.device(device)
        self.tokenizer_path = tokenizer_path
        self.encoder: Optional[UMT5Encoder] = None

    def load(self):
        if self.encoder is None:
            self.encoder = init_umt5_params(self.cfg, seed=7, device=self.device)
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
            # random weights only (real ones raise in __init__): the hash
            # fallback keeps checkpoint-free runs deterministic
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
    CPU. `stop` reads them (synchronising the events)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
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
    def create(cls, model: str = "Wan2.1-1.3B", dit_path: Optional[str] = None,
               vae_path: Optional[str] = None,
               text_encoder_path: Optional[str] = None,
               attention_type: str = "sagesla", sla_topk: float = 0.1,
               quant_linear: bool = False, seed: int = 0,
               sla_block: int = 256, v_quant: str = "channel",
               device="cuda"):
        """Random weights on `device`: DiT from `seed`, VAE from 3, umT5 from
        7, as the JAX package seeds them."""
        if vae_path is not None:
            raise NotImplementedError(
                "VAE checkpoint loading waits for checkpoint import (ROADMAP "
                "Queue A item 14)")
        check_ported(model, attention_type, quant_linear, device)
        device = torch.device(device)
        cfg = make_wan_cfg(model, attention_type, sla_topk, quant_linear,
                           sla_block=sla_block, v_quant=v_quant)
        dit, cfg = load_dit(dit_path, cfg, seed, device)
        if model == "test":
            te = TextEncoder(text_encoder_path, cfg=umt5_test_config(
                dim=cfg.text_dim, text_len=cfg.text_len), device=device)
            vae = init_vae_params(VAEConfig(dim=16, dtype=torch.float32),
                                  seed=3, device=device)
        else:
            te = TextEncoder(text_encoder_path, device=device)
            vae = init_vae_params(VAEConfig(), seed=3, device=device)
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
        receives text_encode_ms, denoise_ms and vae_decode_ms.
        """
        timer = _PhaseTimer(self.device)
        timer.mark("text_encode")
        if text_emb is None:
            text_emb = self.text_encoder(prompt)
        text_emb = text_emb.to(self.device, self.cfg.dtype).repeat_interleave(
            gen.num_samples, dim=0)
        timer.mark("denoise")
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
        timer.mark("vae_decode")
        chunk = 4 if (x.shape[2] - 1) % 4 == 0 else 1
        video = vae_decode(self.vae, x, chunk=chunk)
        video = (1.0 + video.clamp(-1.0, 1.0)) / 2.0
        if timings is not None:
            timer.stop(timings)
        return video
