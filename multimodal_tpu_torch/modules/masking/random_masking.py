"""MAE-style random masking by argsort of uniform noise. Counterpart of
``multimodal_tpu/modules/masking/random_masking.py`` (``random_masking``,
``_random_masking_1d``, ``random_masking_2d``).

Drawing the noise (:func:`masking_noise`, from an explicit
``torch.Generator``) is apart from the argsort-of-noise step, which takes
the noise as an argument: handed the JAX package's noise, the second step
gives the JAX function's result exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class RandomMaskingOutput(NamedTuple):
    x_masked: torch.Tensor
    mask: torch.Tensor
    ids_restore: torch.Tensor
    ids_keep: torch.Tensor


def masking_noise(n: int, length: int, device, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Uniform ``[0, 1)`` noise ``(n, length)``, fp32."""
    return torch.rand((n, length), generator=generator, device=device)


def random_masking(x: torch.Tensor, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> RandomMaskingOutput:
    """Per-sample random masking of ``x (n, l, d)``: the kept tokens
    ``(n, len_keep, d)``, the binary mask (1 = removed) in the original
    order, the restore ids and the keep ids. ``noise (n, l)`` is drawn from
    ``generator`` unless given."""
    n, length, _ = x.shape
    len_keep = int(length * (1 - mask_ratio))
    if len_keep < 1:
        raise ValueError("must keep at least 1 patch")
    if noise is None:
        noise = masking_noise(n, length, x.device, generator)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))
    mask = torch.ones((n, length), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    return RandomMaskingOutput(x_masked, mask, ids_restore, ids_keep)


def _random_masking_1d(x: torch.Tensor, mask_ratio: float, num_patches: int,
                       noise: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Keeps ``len_keep`` of the ``num_patches`` entries of ``x``'s axis 1
    (``x (n, num_patches, m, d)``), by the argsort of ``noise``."""
    len_keep = int(num_patches * (1 - mask_ratio))
    ids_keep = torch.argsort(noise, dim=1, stable=True)[:, :len_keep]
    idx = ids_keep[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3])
    return torch.gather(x, 1, idx), len_keep


def random_masking_2d(x: torch.Tensor, mask_ratio_h: float, mask_ratio_w: float,
                      num_patches_h: int, num_patches_w: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """AudioMAE 2-d masking of ``x (n, h * w, d)``: rows of the patch grid,
    then columns. ``noise`` is the pair ``(noise_h (n, h), noise_w (n, w))``,
    drawn from ``generator`` in that order unless given."""
    n, _, d = x.shape
    if noise is None:
        noise = (masking_noise(n, num_patches_h, x.device, generator),
                 masking_noise(n, num_patches_w, x.device, generator))
    noise_h, noise_w = noise
    x = x.reshape(n, num_patches_h, num_patches_w, d)
    x, len_keep_h = _random_masking_1d(x, mask_ratio_h, num_patches_h, noise_h)
    x = x.transpose(1, 2)
    x, len_keep_w = _random_masking_1d(x, mask_ratio_w, num_patches_w, noise_w)
    x = x.transpose(1, 2)
    return x.reshape(n, len_keep_h * len_keep_w, d)
