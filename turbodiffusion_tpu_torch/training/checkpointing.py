"""Training checkpoints: save, resume, keep the newest three.

Ports `turbodiffusion_tpu/training/checkpointing.py` (reference
rcm/checkpointers/dcp.py: async background save, `latest_checkpoint.txt`
resume selection :427-450, EMA -> regular on load :202-241). Orbax has no
counterpart here: each checkpoint is one `torch.save` file,
`iter_{step:09d}.pth` in the checkpoint directory, holding the state's
`state_dict()` and (when given) the generator's state: a `TrainState`'s
model, optimizer state and step; a `DistillState`'s student, fake score,
EMA, both optimizer states and step (not the frozen teacher, which comes
from its own checkpoint). `save` copies the state to host memory before it
returns; with `async_save` a thread writes the file while training goes on
(`wait` joins it), otherwise `save` writes it itself. The file is written
under a temporary name and renamed, then `latest_checkpoint.txt` names it,
then all but the newest three are removed.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

_NAME = re.compile(r"^iter_(\d{9})\.pth$")
MAX_TO_KEEP = 3


def _host_copy(obj):
    """A copy of a (nested) state whose tensors live in host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class Checkpointer:
    """save / restore of a `TrainState` or `DistillState` keyed by
    iteration."""

    def __init__(self, ckpt_dir: str, async_save: bool = True):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"iter_{step:09d}.pth")

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def save(self, step: int, state: Any,
             generator: Optional[torch.Generator] = None):
        self.wait()
        blob = _host_copy({
            "state": state.state_dict(),
            "generator": None if generator is None else generator.get_state(),
        })
        if self.async_save:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, blob), daemon=True)
            self._thread.start()
        else:
            self._write(step, blob)

    def _write(self, step: int, blob: dict):
        try:
            tmp = self._path(step) + ".tmp"
            torch.save(blob, tmp)
            os.replace(tmp, self._path(step))
            # latest_checkpoint.txt as the reference lays it out (dcp.py:16-49)
            with open(os.path.join(self.dir, "latest_checkpoint.txt"), "w") as f:
                f.write(f"iter_{step:09d}")
            for old in self.steps()[:-MAX_TO_KEEP]:
                os.remove(self._path(old))
        except Exception as e:  # raised again by wait()
            self._error = e

    def wait(self):
        """Join a save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: Any, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """Load checkpoint `step` (default the latest) into `state` (its
        models, EMA and optimizers, in place) and `generator`. Returns
        (state, step), or (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        state.load_state_dict(blob["state"])
        if generator is not None and blob["generator"] is not None:
            generator.set_state(blob["generator"])
        return state, step


def load_ema_as_params(state) -> Any:
    """EMA -> regular weights for inference export (scripts/dcp_to_pth.py:
    36-46 takes net_ema.* as net.*): the state's EMA (a `DistillState`'s
    fp32 tensors by parameter name) where it has one, else its student."""
    ema = getattr(state, "ema", None)
    return ema if ema is not None else state.student
