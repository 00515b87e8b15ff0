"""Checkpoint save and restore over ``torch.save``. Counterpart of
``multimodal_tpu/training/checkpoint.py`` (orbax there).

Each step lives in a directory of its own, ``<directory>/<step>/state.pt``.
A save writes a temporary directory first and moves it into place with
``os.replace``, so a save that is killed leaves at most a temporary
directory behind, never a half-written step: ``latest_step`` sees only
complete steps. The ``max_to_keep`` newest steps are kept.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

_STATE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, _STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Writes ``state`` (tensors, numbers, strings, and lists, tuples and
        dicts of them) as ``step``, then drops the oldest steps past
        ``max_to_keep``."""
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        torch.save(state, os.path.join(tmp, _STATE))
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, map_location: Any = "cpu") -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _STATE),
                          map_location=map_location, weights_only=True)
