"""The port's EmbeddingServer (multimodal_tpu_torch/serving/embedding.py):
bucketing, padding and chunking, held against a direct model call and the
JAX server's bucket ladder."""

import numpy as np
import pytest
import torch

from multimodal_tpu.serving.embedding import EmbeddingServer as JaxEmbeddingServer
from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.model import CLIP, init_parameters_
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.serving.embedding import EmbeddingServer

# fp32 on the CPU; a padded batch may take another BLAS path than the direct
# call, which moves sums by a few ulps
ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    m = CLIP(
        CLIPViTEncoder(embedding_dim=16, patch_size=8, image_size=32, width=64, heads=2, layers=2),
        CLIPTextEncoder(embedding_dim=16, context_length=77, vocab_size=100, width=64,
                        dim_feedforward=256, heads=2, layers=2),
    )
    init_parameters_(m, torch.Generator().manual_seed(0))
    return m.eval()


@pytest.mark.parametrize("max_batch", [4, 6, 256])
def test_bucket_ladder_matches_jax(max_batch):
    server = EmbeddingServer(lambda x: x, device="cpu", max_batch=max_batch)
    assert server.buckets == JaxEmbeddingServer(lambda p, x: x, None, max_batch).buckets


@pytest.mark.parametrize("n", [1, 3, 5, 9])
def test_text_server_matches_direct_call(model, n):
    ids = np.random.RandomState(n).randint(1, 99, size=(n, 77)).astype(np.int64)
    ids[:, 40] = 99  # EOT
    server = EmbeddingServer(model.encode_text, device="cpu", max_batch=4)
    got = server.encode(ids)
    with torch.inference_mode():
        want = model.encode_text(torch.from_numpy(ids)).numpy()
    assert got.shape == (n, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [1, 3, 5, 9])
def test_image_server_matches_direct_call(model, n):
    images = np.random.RandomState(n).randn(n, 32, 32, 3).astype(np.float32)
    server = EmbeddingServer(model.encode_image, device="cpu", max_batch=4)
    got = server.encode(images)
    with torch.inference_mode():
        want = model.encode_image(torch.from_numpy(images)).numpy()
    assert got.shape == (n, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_server_rejects_bad_ladder():
    with pytest.raises(ValueError):
        EmbeddingServer(lambda x: x, device="cpu", max_batch=8, buckets=[1, 4])
