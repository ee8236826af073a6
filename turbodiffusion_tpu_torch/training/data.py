"""Training data: webdataset-style tar shards of precomputed latents.

Ports `turbodiffusion_tpu/training/data.py` (reference
rcm/datasets/webdataset.py): tar shards whose members are grouped by
basename, with the extensions {latent.pt -> latents, embed.pt ->
t5_text_embeddings, prompt.txt -> prompts} (:36-48); shard shuffling by
`seed + epoch` and the `host_id::num_hosts` split (split_by_node). Members
are read with Python's `tarfile`, JAX's fallback; the native reader
(`csrc/host_ops.cpp`) and `build_synthetic_shard` (which needs the VAE
encoder) wait (ROADMAP Queue A items 14 and 10). Samples hold CPU tensors
(bf16 widened to fp32, as JAX's loader does); the loader's batches are
stacked tensors on its `device`.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

KEY_MAP = {  # webdataset.py:36-48
    "latent.pt": "latents",
    "embed.pt": "t5_text_embeddings",
    "prompt.txt": "prompts",
}


def _load_member(name: str, data: bytes):
    if name.endswith(".pt"):
        t = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        return t.float() if t.dtype == torch.bfloat16 else t
    if name.endswith(".txt"):
        return data.decode("utf-8")
    if name.endswith(".npy"):
        return torch.from_numpy(np.load(io.BytesIO(data)))
    return data


def iter_tar_samples(shard_path: str) -> Iterator[Dict]:
    """Group a shard's members by basename and map their extensions to
    batch keys (data.py:45-93, the tarfile branch)."""
    sample: Dict = {}
    current = None
    with tarfile.open(shard_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            base = member.name.partition(".")[0]
            if current is not None and base != current and sample:
                yield sample
                sample = {}
            current = base
            key = KEY_MAP.get(member.name[len(base) + 1:])
            if key is not None:
                sample[key] = _load_member(member.name,
                                           tf.extractfile(member).read())
        if sample:
            yield sample


class WebDatasetLoader:
    """Sharded, shuffled, batched loader over tar shards (data.py:96-142);
    tensors are stacked and moved to `device` (the card unless the caller
    asks for the CPU, as every entry point of the port), strings kept as
    lists."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0,
                 shuffle: bool = True, loop: bool = True, device="cuda"):
        self.shards = sorted(shard_paths)
        if not self.shards:
            raise ValueError("no shards given")
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.shuffle = shuffle
        self.loop = loop
        self.device = torch.device(device)

    def _epoch_shards(self, epoch: int) -> List[str]:
        shards = list(self.shards)
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(shards)
        return shards[self.host_id::self.num_hosts]  # split_by_node

    def __iter__(self):
        epoch = 0
        buf: List[Dict] = []
        while True:
            for shard in self._epoch_shards(epoch):
                for sample in iter_tar_samples(shard):
                    buf.append(sample)
                    if len(buf) == self.batch_size:
                        yield self._collate(buf)
                        buf = []
            epoch += 1
            if not self.loop:
                if buf:
                    yield self._collate(buf)
                return

    def _collate(self, samples: List[Dict]) -> Dict:
        out: Dict = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if torch.is_tensor(vals[0]):
                out[key] = torch.stack(vals).to(self.device)
            else:
                out[key] = vals
        return out


def write_tar_shard(path: str, samples: Sequence[Dict]):
    """Write samples (tensors or numpy arrays, and prompt strings) to a tar
    shard in the reference layout, the inverse of iter_tar_samples
    (data.py:145-168); tensors are saved with torch.save."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    inv = {v: k for k, v in KEY_MAP.items()}
    with tarfile.open(path, "w") as tf:
        for i, sample in enumerate(samples):
            for key, value in sample.items():
                ext = inv.get(key)
                if ext is None:
                    continue
                if ext.endswith(".pt"):
                    t = value if torch.is_tensor(value) else \
                        torch.from_numpy(np.asarray(value))
                    bio = io.BytesIO()
                    torch.save(t.detach().cpu().contiguous(), bio)
                    data = bio.getvalue()
                else:
                    data = str(value).encode("utf-8")
                info = tarfile.TarInfo(name=f"{i:09d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
