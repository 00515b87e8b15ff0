"""FLAVA image transform on the host. Counterpart of
``multimodal_tpu/transforms/flava_transform.py`` (``map_pixels``,
``ImageMaskingGenerator``, ``FLAVAImageTransform``).

One crop, resized two ways: bicubic to the encoder's size (normalised) and
Lanczos to the dVAE codebook's (through the logit-Laplace pixel map), plus
a BEiT-style block mask. The JAX transform resizes with PIL; this one needs
no PIL. It takes a uint8 HWC array (or a PIL image, when the caller has
one) and makes both views in one call of ``native/resample.py``, a C++
copy of PIL's separable resampler for 8-bit images, equal to PIL pixel for
pixel. The crop box and the mask draw from the ``np.random.RandomState``
and ``random.Random`` given, in the JAX transform's order;
``FLAVAImageTransform.plan`` makes the draws (from a RandomState it is
handed, when a data module hands it the batch's) and leaves the resampling
to a function that another thread may run. Output arrays are NHWC float32.
"""

from __future__ import annotations

import math
import random as _random
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

# Copy of multimodal_tpu/transforms/flava_transform.py's constants.
IMAGE_PRETRAINING_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_PRETRAINING_STD = (0.26862954, 0.26130258, 0.27577711)
LOGIT_LAPLACE_EPS = 0.1


def map_pixels(x: np.ndarray) -> np.ndarray:
    """Logit-Laplace pixel map of the DALL-E dVAE's inputs."""
    if not np.issubdtype(x.dtype, np.floating):
        raise ValueError("expected input to have float type")
    return (1 - 2 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


class ImageMaskingGenerator:
    """BEiT block masking: rectangles of random area and aspect ratio until
    the target count of patches is masked."""

    def __init__(
        self,
        input_size: Union[Tuple[int, int], int],
        num_masking_patches: int,
        min_num_patches: int = 4,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
        rng: Optional[_random.Random] = None,
    ) -> None:
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng or _random.Random()

    def _mask(self, mask: np.ndarray, max_mask_patches: int, rng: _random.Random) -> int:
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(self.min_num_patches, max_mask_patches)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.randint(0, self.height - h)
                left = rng.randint(0, self.width - w)
                region = mask[top:top + h, left:left + w]
                new = h * w - int(region.sum())
                if 0 < new <= max_mask_patches:
                    delta = new
                    region[:] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self, rng: Optional[_random.Random] = None) -> np.ndarray:
        """A mask drawn from ``rng``, else from the generator's own."""
        rng = rng or self.rng
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        count = 0
        while count < self.num_masking_patches:
            max_patches = min(self.num_masking_patches - count, self.max_num_patches)
            delta = self._mask(mask, max_patches, rng)
            if delta == 0:
                break
            count += delta
        return mask


def _rgb_array(image) -> np.ndarray:
    """A uint8 HWC RGB array from an array (HW or HWC) or a PIL image."""
    if not isinstance(image, np.ndarray):  # a PIL image
        if image.mode != "RGB":
            image = image.convert("RGB")
        return np.asarray(image, np.uint8)
    image = np.asarray(image, np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got shape {image.shape}")
    return image


class FLAVAImageTransform:
    """Crop, two-way resize, normalisation, codebook mapping and block
    mask. ``rng`` draws the crop; the mask generator's ``rng`` (a
    ``random.Random``) draws the mask."""

    def __init__(
        self,
        is_train: bool = True,
        encoder_input_size: int = 224,
        codebook_input_size: int = 112,
        scale: Tuple[float, float] = (0.9, 1.0),
        image_mean: Tuple[float, ...] = IMAGE_PRETRAINING_MEAN,
        image_std: Tuple[float, ...] = IMAGE_PRETRAINING_STD,
        mask_window_size: int = 14,
        mask_num_patches: int = 75,
        mask_max_patches: Optional[int] = None,
        mask_min_patches: int = 16,
        rng: Optional[np.random.RandomState] = None,
    ) -> None:
        self.is_train = is_train
        self.encoder_input_size = encoder_input_size
        self.codebook_input_size = codebook_input_size
        self.scale = scale
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)
        self.rng = rng or np.random.RandomState()
        self.masked_position_generator = ImageMaskingGenerator(
            mask_window_size, num_masking_patches=mask_num_patches,
            max_num_patches=mask_max_patches, min_num_patches=mask_min_patches)

    def _crop_box(self, h: int, w: int, rng: np.random.RandomState
                  ) -> Optional[Tuple[int, int, int, int]]:
        """The random crop's box, or None (no crop) when training is off or
        ten tries miss."""
        if not self.is_train:
            return None
        area = w * h
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = rng.randint(0, w - cw + 1)
                top = rng.randint(0, h - ch + 1)
                return left, top, left + cw, top + ch
        return None

    def pixel_shapes(self) -> Dict[str, Tuple[int, int, int]]:
        """The HWC shape of each pixel view ``plan``'s function writes."""
        return {"image": (self.encoder_input_size,) * 2 + (3,),
                "image_for_codebook": (self.codebook_input_size,) * 2 + (3,)}

    def plan(self, image, rng: Optional[np.random.RandomState] = None
             ) -> Callable[..., Dict[str, np.ndarray]]:
        """Makes this image's random draws now, the crop box and then the
        mask: from ``rng`` when given (the mask from a ``random.Random``
        seeded by its next draw), else from the transform's own generators.
        Returns ``run(out=None)``, which resamples and normalises the image
        into the arrays of ``out`` (keyed as ``pixel_shapes``) when given;
        its C++ call releases the GIL, so another thread may run it."""
        from multimodal_tpu_torch.native.resample import two_way_native

        img = _rgb_array(image)
        box = self._crop_box(*img.shape[:2], rng or self.rng)
        mask = self.masked_position_generator(
            None if rng is None else _random.Random(int(rng.randint(2 ** 31))))

        def run(out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
            out = out or {}
            enc, code = two_way_native(img, box, self.encoder_input_size,
                                       self.codebook_input_size, self.mean, self.std,
                                       out.get("image"), out.get("image_for_codebook"))
            return {"image": enc, "image_for_codebook": code, "image_patches_mask": mask}

        return run

    def transform(self, image) -> Dict[str, np.ndarray]:
        return self.plan(image)()

    def __call__(self, images) -> Dict[str, np.ndarray]:
        if not isinstance(images, (list, tuple)):
            images = [images]
        outs = [self.transform(im) for im in images]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
