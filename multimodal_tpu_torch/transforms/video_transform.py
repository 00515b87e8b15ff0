"""MUGEN video transform on the device. Counterpart of
``multimodal_tpu/transforms/video_transform.py``: a temporal resample to a
fixed frame count, a bilinear resize, a normalize, over ``(b, t, h, w, c)``
batches on the batch's device.

``jax.image.resize`` antialiases whenever it downsamples: its ``linear``
kernel is a triangle stretched by ``1 / scale`` on a downscale, its weights
renormalised per output sample (``jax.image.scale_and_translate``).
PyTorch has no antialiased linear resize along a time axis (trilinear
``F.interpolate`` is 0.16 off at 40 -> 32 frames), so each axis is resized
here with JAX's own weight matrix (:func:`linear_resize_weights`), a
product along that axis in fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Copy of multimodal_tpu/transforms/video_transform.py's constants.
MUGEN_DEFAULT_TIME_SAMPLES = 32
DEFAULT_MEAN = (0.43216, 0.394666, 0.37645)
DEFAULT_STD = (0.22803, 0.22145, 0.216989)


def linear_resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """``(in_size, out_size)`` fp32 weights of ``jax.image.resize``'s
    antialiased linear (triangle) kernel along one axis: sample ``i`` sits
    at ``(i + 0.5) * in / out - 0.5``; the kernel is widened by ``in / out``
    on a downscale; each column is normalised to sum 1; samples outside
    ``[-0.5, in - 0.5]`` get no weight."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_axis(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` resized along ``dim`` to ``size`` by :func:`linear_resize_weights`."""
    if x.shape[dim] == size:
        return x
    w = linear_resize_weights(x.shape[dim], size, x.device)
    return torch.tensordot(x.movedim(dim, -1), w, dims=1).movedim(-1, dim)


class VideoTransform:
    def __init__(
        self,
        time_samples: int = MUGEN_DEFAULT_TIME_SAMPLES,
        resize_shape: Tuple[int, int] = (224, 224),
        mean: Sequence[float] = DEFAULT_MEAN,
        std: Sequence[float] = DEFAULT_STD,
    ):
        self.time_samples = time_samples
        self.resize_shape = tuple(resize_shape)
        self.mean = tuple(mean)
        self.std = tuple(std)

    def __call__(self, video: torch.Tensor) -> torch.Tensor:
        """video: (b, t, h, w, c) fp32 in [0, 1] or another dtype in
        [0, 255] -> normalized fp32
        (b, T, H, W, c) on the same device."""
        if video.dim() != 5:
            raise ValueError(f"expected (b, t, h, w, c) video, got {tuple(video.shape)}")
        v = video.float()
        if video.dtype != torch.float32:  # as the JAX transform: every other dtype is 0-255
            v = v / 255.0
        v = resize_axis(v, 1, self.time_samples)
        v = resize_axis(v, 2, self.resize_shape[0])
        v = resize_axis(v, 3, self.resize_shape[1])
        mean = torch.tensor(self.mean, dtype=torch.float32, device=v.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=v.device)
        return (v - mean) / std
