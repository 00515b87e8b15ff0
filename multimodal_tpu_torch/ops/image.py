"""Batched on-device image preprocessing. Counterpart of
``multimodal_tpu/ops/image.py``.

``uint8 NHWC -> [0, 1] -> short-side bicubic resize -> center crop ->
normalize``, for a whole batch on the images' device. The resize is
``F.interpolate(mode="bicubic", antialias=True)``, which tracks the JAX
package's ``jax.image.resize(method="cubic")`` (also antialiased) to about
1e-5 in fp32; without ``antialias`` the two differ by about 0.1 on
downscales.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.nn import functional as F

# Copy of multimodal_tpu/transforms/clip_transform.py's constants.
CLIP_DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


def _short_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """(new_h, new_w) with the short side at ``size``, aspect preserved."""
    if h <= w:
        return size, int(round(size * w / h))
    return int(round(size * h / w)), size


def fused_preprocess_for_encoder(
    images_uint8: torch.Tensor,
    size: int = 224,
    mean: Sequence[float] = CLIP_DEFAULT_MEAN,
    std: Sequence[float] = CLIP_DEFAULT_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(b, H, W, 3) uint8 images, all of one size -> (b, size, size, 3)
    normalized NHWC in ``dtype``; the arithmetic is fp32."""
    _, h, w, _ = images_uint8.shape
    new_h, new_w = _short_side_size(h, w, size)
    x = images_uint8.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=(new_h, new_w), mode="bicubic",
                      align_corners=False, antialias=True)
    top = (new_h - size) // 2
    left = (new_w - size) // 2
    x = x[:, :, top:top + size, left:left + size]
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    return ((x - mean_t) / std_t).permute(0, 2, 3, 1).contiguous().to(dtype)
