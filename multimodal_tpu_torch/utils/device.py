"""Default-device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    Raises ``RuntimeError`` when no device was given and CUDA is absent: the
    port never carries on quietly on the CPU. Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
