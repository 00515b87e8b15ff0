"""CoCa model assembly. Counterpart of
``multimodal_tpu/models/coca/coca_model.py`` (``MultimodalOutput``,
``CoCaModel``, ``coca_vit``, ``coca_vit_b_32``, ``coca_vit_l_14``,
``CoCaForPretraining``, ``coca_for_pretraining``, ``CoCaModelWithHeads``).

CoCaModel: the vision transformer (no CLS token: ViT-L/14 at 224 gives 256
tokens, which take the fused attention kernel #1), the attention pooler
(cascaded: 256 captioning tokens, then 1 contrastive token), the text
decoder and the multimodal decoder over the text tokens and the captioning
tokens. ``CoCaForPretraining`` adds the contrastive loss (learned
temperature, clamped) and the captioning cross entropy over the
non-pad next tokens.

The builders take ``device`` (CUDA unless the caller asks for the CPU; on the
meta device only the shapes are built), the compute ``dtype``,
``param_dtype`` for the weights (default ``dtype``; the LayerNorms and
``logit_scale`` stay fp32) and ``seed`` for random weights, drawn on the CPU
so every device gets the same ones.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_tpu_torch.models.coca.multimodal_decoder import CoCaMultimodalDecoder
from multimodal_tpu_torch.models.coca.text_decoder import CoCaTextDecoder, CoCaTextEmbeddings
from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer
from multimodal_tpu_torch.modules.layers.attention_pooler import (
    AttentionPooler,
    CascadedAttentionPooler,
)
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.patch_embedding import PatchEmbeddings
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
    ContrastiveLossWithTemperature,
    cross_entropy,
)
from multimodal_tpu_torch.parallel.collectives import BackpropType
from multimodal_tpu_torch.utils.device import resolve_device


class MultimodalOutput(NamedTuple):
    image_pooled_output: torch.Tensor
    text_pooled_output: torch.Tensor
    multimodal_embeddings: torch.Tensor
    multimodal_pooled_embeddings: Optional[torch.Tensor] = None


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class CoCaModel(nn.Module):
    def __init__(self, vision_encoder: nn.Module, text_decoder: CoCaTextDecoder,
                 multimodal_decoder: CoCaMultimodalDecoder, vision_pooler: nn.Module,
                 vision_proj: nn.Module):
        super().__init__()
        self.vision_encoder = vision_encoder
        self.text_decoder = text_decoder
        self.multimodal_decoder = multimodal_decoder
        self.vision_pooler = vision_pooler
        self.vision_proj = vision_proj

    def encode_image(self, images: torch.Tensor, deterministic: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(captioning tokens, contrastive embedding)``: the pooler's
        first stage (cascaded) or tokens 1.. (one pooler), and the
        normalized projection of its contrastive token."""
        image_embeddings = self.vision_encoder(images, deterministic=deterministic)
        if isinstance(image_embeddings, tuple):  # TransformerOutput or a plain tuple
            image_embeddings = image_embeddings[0]
        pooled = self.vision_pooler(image_embeddings)
        if isinstance(pooled, (list, tuple)):
            captioning, contrastive = pooled
            contrastive = contrastive[:, 0]
        else:
            contrastive, captioning = pooled[:, 0], pooled[:, 1:]
        return captioning, l2norm(dense(self.vision_proj, contrastive, contrastive.dtype))

    def forward(self, images: torch.Tensor, texts: torch.Tensor,
                text_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> MultimodalOutput:
        captioning, contrastive_image = self.encode_image(images, deterministic)
        pooled_text, text_tokens = self.text_decoder(texts, text_padding_mask,
                                                     deterministic=deterministic)
        multimodal = self.multimodal_decoder(text_tokens, captioning,
                                             deterministic=deterministic)
        return MultimodalOutput(contrastive_image, l2norm(pooled_text), multimodal)


def _coca_vit(
    *,
    vision_patch_size: int,
    vision_dim_feedforward: int,
    vision_n_layer: int,
    vision_n_head: int,
    vocab_size: int,
    num_text_positions: int,
    text_hidden_dim: int,
    text_n_layer: int,
    text_n_head: int,
    text_dim_feedforward: int,
    text_output_dim: int,
    fusion_n_layer: int,
    fusion_n_head: int,
    fusion_dim_feedforward: int,
    pooler_input_embed_dim: int,
    pooler_output_embed_dim: int,
    pooler_n_head: int,
    image_size: Union[int, Tuple[int, int]] = 224,
    num_channels: int = 3,
    vision_activation: Union[str, Callable] = "gelu",
    vision_transformer_dropout: float = 0.0,
    patch_embed_dropout_prob: float = 0.0,
    vision_layer_norm_eps: float = 1e-5,
    vision_final_layer_norm_eps: Optional[float] = None,
    vision_norm_first: bool = True,
    vision_include_cls_embed: bool = False,
    vision_drop_path_rate: Optional[float] = None,
    vision_patch_drop_rate: Optional[Union[float, Tuple[float, float]]] = None,
    pad_idx: Optional[int] = 0,
    text_embed_cls: bool = True,
    text_dropout: float = 0.0,
    text_activation: Union[str, Callable] = "gelu",
    text_layer_norm_eps: float = 1e-5,
    text_norm_first: bool = True,
    text_final_layer_norm_eps: Optional[float] = 1e-5,
    fusion_dropout: float = 0.0,
    fusion_activation: Union[str, Callable] = "gelu",
    fusion_layer_norm_eps: float = 1e-5,
    fusion_norm_first: bool = True,
    fusion_final_layer_norm_eps: Optional[float] = 1e-5,
    multimodal_output_projection_dim: Optional[int] = None,
    cascaded_pooler: bool = True,
    pooler_n_queries: int = 256,
    pooler_layer_norm_eps: float = 1e-5,
    dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> CoCaModel:
    if cascaded_pooler:
        vision_pooler: nn.Module = CascadedAttentionPooler([
            AttentionPooler(pooler_input_embed_dim, pooler_output_embed_dim, pooler_n_head,
                            pooler_n_queries, pooler_layer_norm_eps),
            AttentionPooler(pooler_output_embed_dim, pooler_output_embed_dim, pooler_n_head, 1,
                            pooler_layer_norm_eps)])
    else:
        vision_pooler = AttentionPooler(pooler_input_embed_dim, pooler_output_embed_dim,
                                        pooler_n_head, pooler_n_queries + 1,
                                        pooler_layer_norm_eps)
    vision_encoder = vision_transformer(
        patch_size=vision_patch_size, hidden_dim=pooler_input_embed_dim,
        dim_feedforward=vision_dim_feedforward, n_layer=vision_n_layer, n_head=vision_n_head,
        image_size=image_size, num_channels=num_channels, activation=vision_activation,
        transformer_dropout=vision_transformer_dropout,
        patch_embed_dropout_prob=patch_embed_dropout_prob, layer_norm_eps=vision_layer_norm_eps,
        final_layer_norm_eps=vision_final_layer_norm_eps, norm_first=vision_norm_first,
        include_cls_embed=vision_include_cls_embed, drop_path_rate=vision_drop_path_rate,
        patch_drop_rate=vision_patch_drop_rate, dtype=dtype, remat=remat)
    text_decoder = CoCaTextDecoder(
        vocab_size=vocab_size, num_positions=num_text_positions, embedding_dim=text_hidden_dim,
        n_layer=text_n_layer, n_head=text_n_head, dim_feedforward=text_dim_feedforward,
        output_dim=text_output_dim, pad_idx=pad_idx, embed_cls=text_embed_cls,
        dropout=text_dropout, activation=text_activation, layer_norm_eps=text_layer_norm_eps,
        norm_first=text_norm_first, final_layer_norm_eps=text_final_layer_norm_eps, dtype=dtype)
    multimodal_decoder = CoCaMultimodalDecoder(
        input_seq_len=num_text_positions - 1 if text_embed_cls else num_text_positions,
        text_embedding_dim=pooler_output_embed_dim, n_layer=fusion_n_layer,
        n_head=fusion_n_head, dim_feedforward=fusion_dim_feedforward,
        output_dim=multimodal_output_projection_dim, dropout=fusion_dropout,
        activation=fusion_activation, layer_norm_eps=fusion_layer_norm_eps,
        norm_first=fusion_norm_first, final_layer_norm_eps=fusion_final_layer_norm_eps)
    return CoCaModel(vision_encoder=vision_encoder, text_decoder=text_decoder,
                     multimodal_decoder=multimodal_decoder, vision_pooler=vision_pooler,
                     vision_proj=nn.Linear(pooler_output_embed_dim, pooler_output_embed_dim,
                                           bias=False))


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the JAX package's initial scales: fan-in scaled
    normal dense and patch weights, zero biases, unit LayerNorms, token
    embeddings at 0.02, text positions at 0.01, the CLS embedding 0.01, the
    pooler queries unit normal, the vision positions at 0.02 (the JAX module
    starts them at zero). Drawn on the CPU from ``generator``."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, Fp32LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, CoCaTextEmbeddings):
            normal_(m.position_embeddings, 0.01)
            if m.cls_embedding is not None:
                m.cls_embedding.fill_(0.01)
        elif isinstance(m, AttentionPooler):
            normal_(m.query, 1.0)
        elif isinstance(m, PatchEmbeddings):
            normal_(m.position_embeddings, 0.02)


def _built(build: Callable[[], nn.Module], device, dtype, param_dtype, seed: int) -> nn.Module:
    dev = resolve_device(device)
    with torch.device(dev):
        model = build()
    if dev.type != "meta":
        init_parameters_(model, torch.Generator().manual_seed(seed))
    model.to(param_dtype or dtype or torch.float32)
    for m in model.modules():
        if isinstance(m, (Fp32LayerNorm, ContrastiveLossWithTemperature)):
            m.float()
    return model.eval()


def coca_vit(device=None, dtype: Optional[torch.dtype] = None,
             param_dtype: Optional[torch.dtype] = None, seed: int = 0,
             **config: Any) -> CoCaModel:
    """A ``CoCaModel`` with random weights from ``seed``; ``config`` takes
    the JAX builder's keyword arguments."""
    return _built(lambda: _coca_vit(dtype=dtype, **config), device, dtype, param_dtype, seed)


# the published configurations' keyword arguments to ``coca_vit`` (open_clip's
# coca_ViT-B-32 and coca_ViT-L-14)
COCA_CONFIGS: Dict[str, Dict[str, Any]] = {
    "coca_vit_b_32": dict(
        vision_patch_size=32, vision_n_layer=12, vision_n_head=12,
        vision_dim_feedforward=3072, vision_include_cls_embed=False,
        vocab_size=49408, num_text_positions=77, text_hidden_dim=512,
        text_n_layer=12, text_n_head=8, text_dim_feedforward=2048,
        text_output_dim=512, fusion_n_layer=12, fusion_n_head=8,
        fusion_dim_feedforward=2048, multimodal_output_projection_dim=49408,
        pooler_input_embed_dim=768, pooler_output_embed_dim=512,
        pooler_n_head=8, cascaded_pooler=True),
    "coca_vit_l_14": dict(
        vision_patch_size=14, vision_n_layer=24, vision_n_head=16,
        vision_dim_feedforward=4096, vision_include_cls_embed=False,
        vocab_size=49408, num_text_positions=77, text_hidden_dim=768,
        text_n_layer=12, text_n_head=12, text_dim_feedforward=3072,
        text_output_dim=768, fusion_n_layer=12, fusion_n_head=12,
        fusion_dim_feedforward=3072, multimodal_output_projection_dim=49408,
        pooler_input_embed_dim=1024, pooler_output_embed_dim=768,
        pooler_n_head=8, cascaded_pooler=True),
}


def coca_vit_b_32(**kwargs: Any) -> CoCaModel:
    return coca_vit(**COCA_CONFIGS["coca_vit_b_32"], **kwargs)


def coca_vit_l_14(**kwargs: Any) -> CoCaModel:
    return coca_vit(**COCA_CONFIGS["coca_vit_l_14"], **kwargs)


class CoCaForPretraining(nn.Module):
    """Contrastive + captioning losses over ``CoCaModel``."""

    def __init__(self, model: CoCaModel, pad_idx: int = 0,
                 contrastive_logit_scale_min: Optional[float] = math.log(1.0),
                 contrastive_logit_scale_max: Optional[float] = math.log(100.0)):
        super().__init__()
        self.model = model
        self.pad_idx = pad_idx
        self.contrastive_loss = ContrastiveLossWithTemperature(
            logit_scale_min=contrastive_logit_scale_min,
            logit_scale_max=contrastive_logit_scale_max)

    def forward(self, images: torch.Tensor, texts: torch.Tensor,
                text_padding_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                group=None) -> Dict[str, torch.Tensor]:
        outs = self.model(images, texts, text_padding_mask, deterministic=deterministic)
        labels = texts[:, 1:].reshape(-1)
        contrastive = self.contrastive_loss(outs.image_pooled_output, outs.text_pooled_output,
                                            backprop_type=BackpropType.GLOBAL, group=group)
        logits = outs.multimodal_embeddings
        captioning = cross_entropy(logits.reshape(-1, logits.shape[-1]), labels,
                                   weights=(labels != self.pad_idx).float())
        return {"contrastive": contrastive, "captioning": captioning}


def coca_for_pretraining(pad_idx: int = 0, device=None, dtype: Optional[torch.dtype] = None,
                         param_dtype: Optional[torch.dtype] = None, seed: int = 0,
                         **kwargs: Any) -> CoCaForPretraining:
    """``CoCaForPretraining`` over ``coca_vit(**kwargs)``, random weights
    from ``seed``."""
    return _built(lambda: CoCaForPretraining(_coca_vit(dtype=dtype, **kwargs), pad_idx=pad_idx),
                  device, dtype, param_dtype, seed)


class CoCaModelWithHeads(nn.Module):
    """The CoCa trunk and a dict of task heads over the pooled multimodal
    embeddings (``pooler``, default the last token)."""

    def __init__(self, model: CoCaModel, heads: Dict[str, nn.Module], pad_idx: int = 0,
                 pooler: Optional[Callable] = None):
        super().__init__()
        self.model = model
        self.heads = nn.ModuleDict(heads)
        self.pad_idx = pad_idx
        self.pooler = pooler

    def forward(self, images: torch.Tensor, texts: torch.Tensor,
                text_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        mm = self.model(images, texts, text_padding_mask,
                        deterministic=deterministic).multimodal_embeddings
        pooled = self.pooler(mm) if self.pooler is not None else mm[:, -1]
        pooled = pooled.reshape(mm.shape[0], -1)
        return {k: head(pooled) for k, head in self.heads.items()}

