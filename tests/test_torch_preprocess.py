"""The port's image preprocessing (multimodal_tpu_torch/ops/image.py) held
against the JAX package's fused_preprocess_for_encoder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops.image import fused_preprocess_for_encoder as jax_preprocess
from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

# fp32: antialiased bicubic in both libraries (Keys a = -0.5 with the kernel
# widened by the scale on downscales); they agree to about 1e-5 on [0, 1]
# pixels, about 5e-5 after dividing by CLIP's std of ~0.27.
ATOL = 1e-4


@pytest.mark.parametrize("h,w", [(256, 256), (256, 320), (300, 200), (200, 200)])
def test_preprocess_matches_jax(h, w):
    images = np.random.RandomState(h + w).randint(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(images), 224, dtype=jnp.float32))
    got = fused_preprocess_for_encoder(torch.from_numpy(images), 224, dtype=torch.float32)
    assert got.shape == (2, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_preprocess_output_dtype():
    images = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, size=(3, 240, 256, 3), dtype=np.uint8))
    out = fused_preprocess_for_encoder(images, 224)
    assert out.dtype == torch.bfloat16
    assert out.shape == (3, 224, 224, 3) and out.is_contiguous()
