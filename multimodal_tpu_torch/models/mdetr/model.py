"""MDETR: the model, phrase grounding and VQA heads, and host-side
padding. Counterpart of ``multimodal_tpu/models/mdetr/model.py``.

Ragged images and texts are padded on the host (``pad_images``,
``pad_text``) and the model takes padded batches with masks (True =
padded). ``dtype`` is the compute dtype of the convolutions, the text
encoder and, through the tokens' dtype, the transformer and the heads;
weights stay in their parameter dtype and are cast at use. The builders
make random weights from a seed; weights from the JAX package load through
``utils/checkpoint.py:mdetr_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.mdetr.image_encoder import (
    MaskedIntermediateLayer,
    ResNetBackbone,
    position_embedding_2d,
)
from multimodal_tpu_torch.models.mdetr.text_encoder import (
    FeatureResizer,
    mdetr_roberta_text_encoder,
)
from multimodal_tpu_torch.models.mdetr.transformer import MDETRTransformer, MDETRTransformerOutput
from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.utils.device import resolve_device
from multimodal_tpu_torch.utils.init import init_parameters_


class MDETRModelOutput(NamedTuple):
    transformer_output: MDETRTransformerOutput
    pred_logits: torch.Tensor
    pred_boxes: torch.Tensor
    extra_embeddings: Optional[torch.Tensor] = None


class MDETRVQAOutput(NamedTuple):
    model_output: MDETRModelOutput
    vqa_preds: Dict[str, torch.Tensor]
    contrastive_embeddings: Optional[Dict[str, torch.Tensor]] = None


class MDETRPhraseGroundingOutput(NamedTuple):
    model_output: MDETRModelOutput
    contrastive_embeddings: Dict[str, torch.Tensor]


def pad_images(images: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged NHWC images -> a padded batch and its mask (True = padded)."""
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    c = images[0].shape[2]
    batch = np.zeros((len(images), max_h, max_w, c), images[0].dtype)
    mask = np.ones((len(images), max_h, max_w), bool)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        batch[i, :h, :w] = im
        mask[i, :h, :w] = False
    return batch, mask


def pad_text(text: List[np.ndarray], padding_idx: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    max_len = max(len(t) for t in text)
    batch = np.full((len(text), max_len), padding_idx, np.int32)
    for i, t in enumerate(text):
        batch[i, : len(t)] = t
    return batch, batch == padding_idx


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return F.linear(x, lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))


class MDETR(nn.Module):
    def __init__(self, image_backbone: MaskedIntermediateLayer, text_encoder: nn.Module,
                 transformer: MDETRTransformer, text_projection: nn.Module,
                 image_projection: nn.Conv2d, num_queries: int = 100,
                 num_extra_queries: int = 0, hidden_dim: int = 256, num_classes: int = 255,
                 pos_feats: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_backbone = image_backbone
        self.text_encoder = text_encoder
        self.transformer = transformer
        self.text_projection = text_projection
        self.image_projection = image_projection
        self.num_queries = num_queries
        self.num_extra_queries = num_extra_queries
        self.pos_feats = pos_feats
        self.dtype = dtype
        self.query_embed = nn.Parameter(torch.randn(num_queries + num_extra_queries, hidden_dim))
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, 4, [hidden_dim] * 2, dropout=0.0, activation="relu")

    def forward(
        self,
        images: torch.Tensor,               # (b, H, W, 3) padded
        image_mask: torch.Tensor,           # (b, H, W) True = padded
        text: torch.Tensor,                 # (b, L) padded token ids
        text_attention_mask: torch.Tensor,  # (b, L) True = padded
        deterministic: bool = True,
    ) -> MDETRModelOutput:
        encoded_text = self.text_encoder(input_ids=text, attention_mask=~text_attention_mask,
                                         deterministic=deterministic)
        text_memory = self.text_projection(encoded_text.last_hidden_state, deterministic)

        feats, feat_mask = self.image_backbone(images, image_mask)
        pos = position_embedding_2d(feat_mask, num_pos_feats=self.pos_feats,
                                    scale=2 * math.pi).to(feats.dtype)
        proj = self.image_projection
        img_proj = F.conv2d(feats.permute(0, 3, 1, 2).to(self.dtype), proj.weight.to(self.dtype),
                            proj.bias.to(self.dtype)).permute(0, 2, 3, 1)
        tf_out = self.transformer(img_proj, feat_mask, self.query_embed, pos, text_memory,
                                  text_attention_mask, deterministic=deterministic)

        extra_embeddings = None
        hs = tf_out.decoder_hidden_states
        if self.num_extra_queries > 0:
            extra_embeddings = hs[-1, :, -self.num_extra_queries:]
            hs = hs[:, :, : self.num_queries]
            tf_out = tf_out._replace(decoder_hidden_states=hs)
        final = hs[-1]
        outputs_class = _dense(self.class_embed, final)
        outputs_coord = torch.sigmoid(self.bbox_embed(final))
        return MDETRModelOutput(tf_out, outputs_class, outputs_coord, extra_embeddings)


def mdetr_resnet101(
    num_queries: int = 100,
    num_classes: int = 255,
    embedding_dim: int = 768,
    transformer_d_model: int = 256,
    transformer_num_heads: int = 8,
    transformer_encoder_layers: int = 6,
    transformer_decoder_layers: int = 6,
    transformer_dim_feedforward: int = 2048,
    transformer_dropout: float = 0.1,
    return_intermediate_dec: bool = True,
    num_extra_query_embeddings: int = 0,
    text_encoder_kwargs: Optional[dict] = None,
    resnet_layers: Sequence[int] = (3, 4, 23, 3),
    dtype: torch.dtype = torch.float32,
) -> MDETR:
    """The MDETR model with PyTorch's initial weights (see
    :func:`mdetr_for_phrase_grounding` for a seeded one)."""
    backbone = ResNetBackbone(layers=tuple(resnet_layers), dtype=dtype)
    return MDETR(
        image_backbone=MaskedIntermediateLayer(backbone),
        text_encoder=mdetr_roberta_text_encoder(hidden_size=embedding_dim,
                                                **(text_encoder_kwargs or {}), dtype=dtype),
        transformer=MDETRTransformer(
            d_model=transformer_d_model, num_heads=transformer_num_heads,
            num_encoder_layers=transformer_encoder_layers,
            num_decoder_layers=transformer_decoder_layers,
            dim_feedforward=transformer_dim_feedforward, dropout=transformer_dropout,
            return_intermediate_dec=return_intermediate_dec),
        text_projection=FeatureResizer(embedding_dim, transformer_d_model),
        image_projection=nn.Conv2d(backbone.out_channels, transformer_d_model, 1),
        num_queries=num_queries,
        num_extra_queries=num_extra_query_embeddings,
        hidden_dim=transformer_d_model,
        num_classes=num_classes,
        pos_feats=transformer_d_model // 2,  # the sine embedding's width is d_model
        dtype=dtype,
    )


class MDETRForVQA(nn.Module):
    """MDETR + per-task VQA heads over the extra query embeddings; the heads
    are registered as ``vqa_heads_<name>``, the JAX module's names."""

    def __init__(self, model: MDETR, vqa_heads: Dict[str, nn.Module]):
        super().__init__()
        self.model = model
        self.head_names = sorted(vqa_heads)
        for name in self.head_names:
            self.add_module(f"vqa_heads_{name}", vqa_heads[name])

    def forward(self, images, image_mask, text, text_attention_mask,
                deterministic: bool = True) -> MDETRVQAOutput:
        out = self.model(images, image_mask, text, text_attention_mask, deterministic)
        if out.extra_embeddings is None:
            raise ValueError("MDETRForVQA requires extra query embeddings")
        preds = {name: getattr(self, f"vqa_heads_{name}")(out.extra_embeddings[:, i])
                 for i, name in enumerate(self.head_names)}
        return MDETRVQAOutput(out, preds)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class MDETRForPhraseGrounding(nn.Module):
    """MDETR + the contrastive alignment projections of the last decoder
    state (queries) and the encoder's text rows (tokens)."""

    def __init__(self, model: MDETR, contrastive_dim: int = 64, hidden_dim: int = 256):
        super().__init__()
        self.model = model
        self.contrastive_align_image = nn.Linear(hidden_dim, contrastive_dim)
        self.contrastive_align_text = nn.Linear(hidden_dim, contrastive_dim)

    def forward(self, images, image_mask, text, text_attention_mask,
                deterministic: bool = True) -> MDETRPhraseGroundingOutput:
        out = self.model(images, image_mask, text, text_attention_mask, deterministic)
        query_emb = _dense(self.contrastive_align_image,
                           out.transformer_output.decoder_hidden_states[-1])
        token_emb = _dense(self.contrastive_align_text, out.transformer_output.text_memory)
        return MDETRPhraseGroundingOutput(out, {"query_embeddings": _l2_normalize(query_emb),
                                                "token_embeddings": _l2_normalize(token_emb)})


def mdetr_gqa_heads(hidden_dim: int = 256) -> Dict[str, nn.Module]:
    """GQA answer-type heads."""
    sizes = {"answer_type": 5, "answer_obj": 3, "answer_rel": 1594,
             "answer_attr": 403, "answer_cat": 678, "answer_global": 111}
    return {name: MLP(hidden_dim, n, [hidden_dim], dropout=0.0, activation="relu")
            for name, n in sizes.items()}


def _built(model: nn.Module, device: torch.device, seed: int) -> nn.Module:
    """``model`` with random weights from ``seed`` (drawn on the CPU at
    flax's default scales, the query embeddings unit normal), on
    ``device``, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    init_parameters_(model, gen)
    for m in model.modules():
        if isinstance(m, MDETR):
            with torch.no_grad():
                m.query_embed.copy_(torch.randn(m.query_embed.shape, generator=gen))
        if isinstance(m, Fp32LayerNorm):
            m.float()
    return model.to(device).eval()


def mdetr_for_vqa(num_extra_query_embeddings: int = 6, device=None, seed: int = 0,
                  **kwargs: Any) -> MDETRForVQA:
    dev = resolve_device(device)
    model = mdetr_resnet101(num_extra_query_embeddings=num_extra_query_embeddings, **kwargs)
    return _built(MDETRForVQA(model, mdetr_gqa_heads(model.query_embed.shape[1])), dev, seed)


def mdetr_for_phrase_grounding(contrastive_dim: int = 64, device=None, seed: int = 0,
                               **kwargs: Any) -> MDETRForPhraseGrounding:
    """MDETR phrase grounding at the JAX builder's defaults (ResNet-101,
    RoBERTa-base, d_model 256, 8 heads, 6 + 6 layers, 100 queries, a 64-d
    alignment), fp32 weights, random from ``seed``; on CUDA unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    model = mdetr_resnet101(**kwargs)
    return _built(MDETRForPhraseGrounding(model, contrastive_dim, model.query_embed.shape[1]),
                  dev, seed)
