"""The PyTorch port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "turbodiffusion_tpu_torch",
    "turbodiffusion_tpu_torch.config",
    "turbodiffusion_tpu_torch.models.layers",
    "turbodiffusion_tpu_torch.models.rope",
    "turbodiffusion_tpu_torch.models.wan",
    "turbodiffusion_tpu_torch.models.umt5",
    "turbodiffusion_tpu_torch.models.vae",
    "turbodiffusion_tpu_torch.ops._build",
    "turbodiffusion_tpu_torch.ops.fused_norm",
    "turbodiffusion_tpu_torch.ops.flash_attention",
    "turbodiffusion_tpu_torch.ops.sla_fused",
    "turbodiffusion_tpu_torch.ops.sparse_i8_attention",
    "turbodiffusion_tpu_torch.ops.quant",
    "turbodiffusion_tpu_torch.ops.attention",
    "turbodiffusion_tpu_torch.ops.linear_attention",
    "turbodiffusion_tpu_torch.ops.sparse_attention_bwd",
    "turbodiffusion_tpu_torch.pipelines.sampler",
    "turbodiffusion_tpu_torch.pipelines.pipeline",
    "turbodiffusion_tpu_torch.inference.wan2_1_t2v",
    "turbodiffusion_tpu_torch.utils.video_io",
    "turbodiffusion_tpu_torch.utils.jax_params",
    "turbodiffusion_tpu_torch.training.timesteps",
    "turbodiffusion_tpu_torch.training.train_step",
    "turbodiffusion_tpu_torch.training.data",
    "turbodiffusion_tpu_torch.training.checkpointing",
    "turbodiffusion_tpu_torch.training.trainer",
    "turbodiffusion_tpu_torch.scripts.train",
]


def test_slice_imports_no_jax():
    """A fresh interpreter (only the repo on its path) imports every module
    of the slice; afterwards neither jax nor turbodiffusion_tpu is loaded,
    and no kernel was built."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'turbodiffusion_tpu.')) or m == 'turbodiffusion_tpu')\n"
        "assert not bad, bad\n"
        "from turbodiffusion_tpu_torch.ops import _build\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
