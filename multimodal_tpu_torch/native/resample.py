"""PIL's 8-bit resampler in C++ (``native/resample.cpp``, built by
``native/_build.py`` at first use): ``resample_native``, equal to PIL's
``Image.resize`` pixel for pixel, and ``two_way_native``, the FLAVA
transform's two views of an image in one call
(``transforms/flava_transform.py``). The calls release the GIL, so threads
transform images at once. A failed build raises."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from multimodal_tpu_torch.native import _build

SOURCE = "resample.cpp"
FILTER_CODES = {"bicubic": 0, "lanczos": 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.flava_resample_u8.restype = ctypes.c_int
    lib.flava_resample_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int]
    lib.flava_two_way_f32.restype = ctypes.c_int
    lib.flava_two_way_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _rgb(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got shape {img.shape}")
    return img


def resample_native(img: np.ndarray, size: Tuple[int, int], name: str,
                    box: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """``Image.resize((w, h), filter, box)`` of an RGB uint8 HWC array."""
    img = _rgb(img)
    h, w, _ = img.shape
    box = (0, 0, w, h) if box is None else box
    out = np.empty((size[1], size[0], 3), np.uint8)
    rc = _library().flava_resample_u8(img.ctypes.data, h, w, out.ctypes.data, size[0],
                                      size[1], *map(float, box), FILTER_CODES[name])
    if rc != 0:
        raise ValueError(f"cannot resample {img.shape} to {size} with box {box}")
    return out


def two_way_native(img: np.ndarray, box: Optional[Tuple[float, float, float, float]],
                   enc_size: int, code_size: int, mean: np.ndarray, std: np.ndarray,
                   enc: Optional[np.ndarray] = None, code: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The FLAVA transform's views of an RGB uint8 HWC image: the bicubic
    encoder view, normalised, and the Lanczos codebook view through the
    dVAE's pixel map (without a box, resized from the encoder view);
    written into ``enc`` and ``code`` when given (C-contiguous fp32)."""
    img = _rgb(img)
    h, w, _ = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    for name, a, n in (("enc", enc, enc_size), ("code", code, code_size)):
        if a is not None and (a.shape != (n, n, 3) or a.dtype != np.float32
                              or not a.flags.c_contiguous):
            raise ValueError(f"{name} must be a C-contiguous ({n}, {n}, 3) float32 array")
    enc = np.empty((enc_size, enc_size, 3), np.float32) if enc is None else enc
    code = np.empty((code_size, code_size, 3), np.float32) if code is None else code
    rc = _library().flava_two_way_f32(
        img.ctypes.data, h, w, int(box is not None), *map(float, box or (0, 0, w, h)),
        enc_size, code_size, mean.ctypes.data, std.ctypes.data, enc.ctypes.data,
        code.ctypes.data)
    if rc != 0:
        raise ValueError(f"cannot transform an image of shape {img.shape}")
    return enc, code
