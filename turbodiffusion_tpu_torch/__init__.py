"""TurboDiffusion in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of `turbodiffusion_tpu` (JAX/Pallas), which stays the
reference each module is held against. Module paths and function names follow
the JAX package; every Pallas kernel on the ported path is a kernel written by
hand for `sm_90a` (CUDA C++ under `csrc/`, built and bound by `ops/_build.py`).

Ported so far: Wan2.1 T2V with `original` (dense) or `sla` attention and bf16
linears — config, DiT, umT5, VAE decode, rCM sampler, pipeline and CLI.

Float32 matrix products and convolutions run in full float32: both TF32
switches are stated here, once, so the fp32 islands of the model (time
embedding, AdaLN, head) and the plain reference versions of the kernels keep
float32 precision on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
