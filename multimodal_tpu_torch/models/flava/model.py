"""FLAVA model assembly. Counterpart of ``multimodal_tpu/models/flava/model.py``
(``FLAVAModel``, ``FLAVAForPreTraining``, ``FLAVAForClassification``,
``flava_multimodal_encoder``, ``flava_model``, ``flava_model_for_pretraining``,
``flava_model_for_classification``).

A pretraining forward runs the unmasked and masked unimodal passes and the
masked multimodal pass: with no ``image_patches_mask`` the two image passes
see identical inputs and both run, as the JAX package writes them (four
unimodal encoder passes and the multimodal encoder per step). The
multimodal encoder takes the last pre-final-LayerNorm hidden state of each
unimodal tower.

The builders take ``device`` (CUDA unless the caller asks for the CPU), the
compute ``dtype``, ``param_dtype`` for the weights (default ``dtype``; the
LayerNorms and ``logit_scale`` stay fp32) and ``seed`` for random weights
with the JAX package's initial scales. ``FLAVAForPreTraining`` carries the
frozen dVAE codebook (``dalle_vae.py``) that turns ``image_for_codebook``
into MIM labels; it gets no gradient and no optimizer update. Not ported
yet: MoE towers (ROADMAP.md, queues A4 and A7).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from multimodal_tpu_torch.models.flava.dalle_vae import DalleVAEEncoder
from multimodal_tpu_torch.models.flava.image_encoder import ImageEmbeddings, flava_image_encoder
from multimodal_tpu_torch.models.flava.text_encoder import flava_text_encoder
from multimodal_tpu_torch.models.flava.transformer import FLAVATransformerWithoutEmbeddings
from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.transformer import TransformerEncoder, TransformerOutput
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import cross_entropy
from multimodal_tpu_torch.modules.losses.flava import (
    FLAVAGlobalContrastiveLoss,
    FLAVAPretrainingLoss,
    FLAVAPretrainingLossOutput,
    MaskedPredictionHead,
    Pooler,
)
from multimodal_tpu_torch.utils.device import resolve_device


class FLAVAOutput(NamedTuple):
    image: TransformerOutput = TransformerOutput()
    image_masked: TransformerOutput = TransformerOutput()
    text: TransformerOutput = TransformerOutput()
    text_masked: TransformerOutput = TransformerOutput()
    multimodal: TransformerOutput = TransformerOutput()
    multimodal_masked: TransformerOutput = TransformerOutput()
    projected_image_embeddings: Optional[torch.Tensor] = None
    projected_text_embeddings: Optional[torch.Tensor] = None


def flava_multimodal_encoder(
    hidden_size: int = 768,
    num_attention_heads: int = 12,
    num_hidden_layers: int = 12,
    dropout: float = 0.0,
    intermediate_size: int = 3072,
    intermediate_activation: Union[str, Callable] = "gelu",
    layer_norm_eps: float = 1e-12,
    remat: bool = False,
    moe_num_experts: Optional[int] = None,
) -> FLAVATransformerWithoutEmbeddings:
    encoder = TransformerEncoder(
        n_layer=num_hidden_layers, d_model=hidden_size, n_head=num_attention_heads,
        dim_feedforward=intermediate_size, activation=intermediate_activation,
        layer_norm_eps=layer_norm_eps, dropout=dropout, norm_first=True, remat=remat,
        moe_num_experts=moe_num_experts)
    return FLAVATransformerWithoutEmbeddings(
        encoder=encoder, layernorm=Fp32LayerNorm(hidden_size, eps=layer_norm_eps),
        pooler=Pooler(hidden_size), hidden_size=hidden_size)


class FLAVAModel(nn.Module):
    def __init__(self, image_encoder: nn.Module, text_encoder: nn.Module, mm_encoder: nn.Module,
                 image_to_mm_projection: nn.Module, text_to_mm_projection: nn.Module,
                 text_projection: nn.Module, image_projection: nn.Module):
        super().__init__()
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.mm_encoder = mm_encoder
        self.image_to_mm_projection = image_to_mm_projection
        self.text_to_mm_projection = text_to_mm_projection
        self.text_projection = text_projection
        self.image_projection = image_projection

    def encode_image(self, image: torch.Tensor,
                     image_patches_mask: Optional[torch.Tensor] = None,
                     projection: bool = False, deterministic: bool = True):
        encoded = self.image_encoder(image, image_patches_mask=image_patches_mask,
                                     deterministic=deterministic)
        if projection:
            cls = encoded.last_hidden_state[:, 0, :]
            return encoded, dense(self.image_projection, cls, cls.dtype)
        return encoded

    def encode_text(self, text: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
                    projection: bool = False, deterministic: bool = True):
        encoded = self.text_encoder(input_ids=text, attention_mask=text_mask,
                                    return_hidden_states=True, return_attn_weights=True,
                                    deterministic=deterministic)
        if projection:
            cls = encoded.last_hidden_state[:, 0, :]
            return encoded, dense(self.text_projection, cls, cls.dtype)
        return encoded

    def encode_mm(self, image_embedding: Optional[torch.Tensor],
                  text_embedding: Optional[torch.Tensor],
                  deterministic: bool = True) -> TransformerOutput:
        if image_embedding is None or text_embedding is None:
            return TransformerOutput()
        dt = image_embedding.dtype
        fused = torch.cat([dense(self.image_to_mm_projection, image_embedding, dt),
                           dense(self.text_to_mm_projection, text_embedding, dt)], dim=1)
        return self.mm_encoder(fused, deterministic=deterministic)

    def forward(
        self,
        image: Optional[torch.Tensor] = None,
        text: Optional[torch.Tensor] = None,
        image_patches_mask: Optional[torch.Tensor] = None,
        text_masked: Optional[torch.Tensor] = None,
        required_embedding: Optional[str] = None,
        skip_unmasked_mm_encoder: bool = True,
        deterministic: bool = True,
    ) -> FLAVAOutput:
        if required_embedding is None:
            if image is not None and text is not None:
                required_embedding = "mm"
            elif image is not None:
                required_embedding = "image"
            else:
                required_embedding = "text"

        empty = TransformerOutput()
        image_outputs, projected_image = empty, None
        text_outputs, projected_text = empty, None
        image_masked_outputs, text_masked_outputs = empty, empty

        if image is not None and required_embedding in ("image", "mm"):
            image_outputs, projected_image = self.encode_image(
                image, projection=True, deterministic=deterministic)
            image_masked_outputs = self.encode_image(
                image, image_patches_mask=image_patches_mask, deterministic=deterministic)
        if text is not None and required_embedding in ("text", "mm"):
            text_outputs, projected_text = self.encode_text(
                text, projection=True, deterministic=deterministic)
        if text_masked is not None and required_embedding in ("text", "mm"):
            text_masked_outputs = self.encode_text(text_masked, deterministic=deterministic)

        def last_tap(out: TransformerOutput) -> Optional[torch.Tensor]:
            return out.hidden_states[-1] if out.hidden_states else None

        multimodal_outputs = TransformerOutput()
        multimodal_masked_outputs = TransformerOutput()
        if required_embedding == "mm":
            if not skip_unmasked_mm_encoder:
                multimodal_outputs = self.encode_mm(
                    last_tap(image_outputs), last_tap(text_outputs), deterministic)
            multimodal_masked_outputs = self.encode_mm(
                last_tap(image_masked_outputs), last_tap(text_masked_outputs), deterministic)

        return FLAVAOutput(
            image=image_outputs, image_masked=image_masked_outputs, text=text_outputs,
            text_masked=text_masked_outputs, multimodal=multimodal_outputs,
            multimodal_masked=multimodal_masked_outputs,
            projected_image_embeddings=projected_image,
            projected_text_embeddings=projected_text)


class FLAVAForClassificationOutput(NamedTuple):
    logits: torch.Tensor
    loss: Optional[torch.Tensor]


class FLAVAForPreTraining(nn.Module):
    """``FLAVAModel``, its pretraining losses and the frozen dVAE codebook:
    with ``image_for_codebook`` (and ``image_patches_mask``) the MIM labels
    are the codebook indices of the masked patches, -1 elsewhere."""

    def __init__(self, model: FLAVAModel, loss: FLAVAPretrainingLoss,
                 image_codebook: nn.Module):
        super().__init__()
        self.model = model
        self.loss = loss
        self.image_codebook = image_codebook

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.model.encode_image(image, projection=True)[1]

    def encode_text(self, text: torch.Tensor, text_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        return self.model.encode_text(text, text_mask, projection=True)[1]

    def forward(
        self,
        image: Optional[torch.Tensor] = None,
        text: Optional[torch.Tensor] = None,
        image_for_codebook: Optional[torch.Tensor] = None,
        image_patches_mask: Optional[torch.Tensor] = None,
        text_masked: Optional[torch.Tensor] = None,
        required_embedding: Optional[str] = None,
        skip_unmasked_mm_encoder: bool = True,
        itm_labels: Optional[torch.Tensor] = None,
        mlm_labels: Optional[torch.Tensor] = None,
        deterministic: bool = True,
    ) -> FLAVAPretrainingLossOutput:
        image_labels = None
        if image_for_codebook is not None:
            b = image_for_codebook.shape[0]
            image_labels = self.image_codebook(image_for_codebook).reshape(b, -1)
            mask = image_patches_mask.reshape(image_patches_mask.shape[0], -1).bool()
            image_labels = torch.where(mask, image_labels, -1)
        out = self.model(image=image, text=text, image_patches_mask=image_patches_mask,
                         text_masked=text_masked, required_embedding=required_embedding,
                         skip_unmasked_mm_encoder=skip_unmasked_mm_encoder,
                         deterministic=deterministic)
        return self.loss(
            image_sequence=out.image.last_hidden_state,
            text_sequence=out.text.last_hidden_state,
            image_masked_sequence=out.image_masked.last_hidden_state,
            text_masked_sequence=out.text_masked.last_hidden_state,
            multimodal_sequence=(out.multimodal.last_hidden_state
                                 if not skip_unmasked_mm_encoder else None),
            multimodal_masked_sequence=out.multimodal_masked.last_hidden_state,
            itm_labels=itm_labels,
            mim_labels=image_labels,
            mlm_labels=mlm_labels,
            projected_image_embeddings=out.projected_image_embeddings,
            projected_text_embeddings=out.projected_text_embeddings,
        )


class FLAVAForClassification(nn.Module):
    """``FLAVAModel`` and a classifier head over one CLS token: the
    multimodal encoder's (the default), the image tower's or the text
    tower's, as ``required_embedding`` asks."""

    def __init__(self, model: FLAVAModel, classifier: nn.Module,
                 loss_fn: Optional[Callable] = None):
        super().__init__()
        self.model = model
        self.classifier = classifier
        self.loss_fn = loss_fn

    def forward(self, image: Optional[torch.Tensor] = None, text: Optional[torch.Tensor] = None,
                required_embedding: Optional[str] = None,
                labels: Optional[torch.Tensor] = None, cls_index: int = 0,
                deterministic: bool = True) -> FLAVAForClassificationOutput:
        out = self.model(image=image, text=text, required_embedding=required_embedding,
                         skip_unmasked_mm_encoder=False, deterministic=deterministic)
        if required_embedding == "image":
            hidden = out.image.last_hidden_state
        elif required_embedding == "text":
            hidden = out.text.last_hidden_state
        else:
            hidden = out.multimodal.last_hidden_state
        scores = self.classifier(hidden[:, cls_index], deterministic=deterministic)
        loss = None
        if labels is not None:
            fn = self.loss_fn if self.loss_fn is not None else cross_entropy
            loss = fn(scores, labels.long())
        return FLAVAForClassificationOutput(logits=scores, loss=loss)


def _flava_model(
    image_hidden_size: int = 768,
    image_num_attention_heads: int = 12,
    image_num_hidden_layers: int = 12,
    image_dropout: float = 0.0,
    image_intermediate_size: int = 3072,
    image_intermediate_activation: Union[str, Callable] = "gelu",
    image_layer_norm_eps: float = 1e-12,
    use_image_masking: bool = True,
    image_size: int = 224,
    patch_size: int = 16,
    num_channels: int = 3,
    text_hidden_size: int = 768,
    text_num_attention_heads: int = 12,
    text_num_hidden_layers: int = 12,
    text_dropout: float = 0.0,
    text_intermediate_size: int = 3072,
    text_intermediate_activation: Union[str, Callable] = "gelu",
    text_layer_norm_eps: float = 1e-12,
    vocab_size: int = 30522,
    pad_token_id: int = 0,
    type_vocab_size: int = 2,
    max_position_embeddings: int = 512,
    multimodal_hidden_size: int = 768,
    multimodal_num_attention_heads: int = 12,
    multimodal_num_hidden_layers: int = 6,
    multimodal_dropout: float = 0.0,
    multimodal_intermediate_size: int = 3072,
    multimodal_intermediate_activation: Union[str, Callable] = "gelu",
    multimodal_layer_norm_eps: float = 1e-12,
    text_and_image_proj_size: int = 768,
    dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    moe_num_experts: Optional[int] = None,
    **kwargs: Any,
) -> FLAVAModel:
    if moe_num_experts:
        raise NotImplementedError(
            "MoE FLAVA towers are not ported yet (ROADMAP.md, queues A4 and A7)")
    image_encoder = flava_image_encoder(
        hidden_size=image_hidden_size, num_attention_heads=image_num_attention_heads,
        num_hidden_layers=image_num_hidden_layers, use_image_masking=use_image_masking,
        dropout=image_dropout, intermediate_size=image_intermediate_size,
        intermediate_activation=image_intermediate_activation,
        layer_norm_eps=image_layer_norm_eps, image_size=image_size, patch_size=patch_size,
        num_channels=num_channels, dtype=dtype, remat=remat)
    text_encoder = flava_text_encoder(
        hidden_size=text_hidden_size, num_attention_heads=text_num_attention_heads,
        num_hidden_layers=text_num_hidden_layers, dropout=text_dropout,
        intermediate_size=text_intermediate_size,
        intermediate_activation=text_intermediate_activation,
        layer_norm_eps=text_layer_norm_eps, vocab_size=vocab_size, pad_token_id=pad_token_id,
        type_vocab_size=type_vocab_size, max_position_embeddings=max_position_embeddings,
        dtype=dtype, remat=remat)
    mm_encoder = flava_multimodal_encoder(
        hidden_size=multimodal_hidden_size, num_attention_heads=multimodal_num_attention_heads,
        num_hidden_layers=multimodal_num_hidden_layers, dropout=multimodal_dropout,
        intermediate_size=multimodal_intermediate_size,
        intermediate_activation=multimodal_intermediate_activation,
        layer_norm_eps=multimodal_layer_norm_eps, remat=remat)
    return FLAVAModel(
        image_encoder=image_encoder, text_encoder=text_encoder, mm_encoder=mm_encoder,
        image_to_mm_projection=nn.Linear(image_hidden_size, multimodal_hidden_size),
        text_to_mm_projection=nn.Linear(text_hidden_size, multimodal_hidden_size),
        text_projection=nn.Linear(text_hidden_size, text_and_image_proj_size),
        image_projection=nn.Linear(image_hidden_size, text_and_image_proj_size))


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initial scales: fan-in scaled
    normal dense, conv and embedding weights, zero biases, unit LayerNorms;
    CLS, mask tokens and position embeddings stay zero, ``logit_scale`` at
    its initial value. Drawn on the CPU from ``generator``, so every device
    gets the same weights from one seed."""

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
            normal_(m.weight, m.embedding_dim ** -0.5)
        elif isinstance(m, ImageEmbeddings):
            for p in (m.position_embeddings, m.cls_token, m.mask_token):
                if p is not None:
                    p.zero_()
        elif isinstance(m, FLAVATransformerWithoutEmbeddings) and m.cls_token is not None:
            m.cls_token.zero_()
        elif isinstance(m, MaskedPredictionHead):
            m.bias.zero_()


def _built(build: Callable[[], nn.Module], device, dtype, param_dtype, seed: int) -> nn.Module:
    dev = resolve_device(device)
    with torch.device(dev):
        model = build()
    init_parameters_(model, torch.Generator().manual_seed(seed))
    model.to(param_dtype or dtype)
    for m in model.modules():
        if isinstance(m, (Fp32LayerNorm, FLAVAGlobalContrastiveLoss)):
            m.float()
    return model.eval()


def flava_model(device=None, dtype: torch.dtype = torch.float32,
                param_dtype: Optional[torch.dtype] = None, seed: int = 0,
                **config: Any) -> FLAVAModel:
    """A ``FLAVAModel`` with random weights from ``seed``; ``config`` takes
    the JAX builder's keyword arguments (``FLAVA_CONFIGS`` entries)."""
    return _built(lambda: _flava_model(dtype=dtype, **config), device, dtype, param_dtype, seed)


def flava_model_for_pretraining(
    device=None,
    dtype: torch.dtype = torch.float32,
    param_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    codebook_image_size: int = 112,
    logit_scale_init: float = math.log(1 / 0.07),
    **flava_model_kwargs: Any,
) -> FLAVAForPreTraining:
    """``FLAVAForPreTraining`` with random weights from ``seed``, the dVAE
    codebook in the model's dtypes. The loss heads keep the vocabularies of
    the JAX package's function (text 30522, image 8192) whatever the model's
    ``vocab_size``, as the JAX package does."""
    hidden_size = flava_model_kwargs.get("multimodal_hidden_size", 768)

    def build():
        # the codebook is registered last, so the other weights draw from
        # the seed as they did before it was ported
        return FLAVAForPreTraining(
            model=_flava_model(dtype=dtype, **flava_model_kwargs),
            loss=FLAVAPretrainingLoss(logit_scale_init=logit_scale_init,
                                      hidden_size=hidden_size),
            image_codebook=DalleVAEEncoder(image_size=codebook_image_size, dtype=dtype))

    return _built(build, device, dtype, param_dtype, seed)


def flava_model_for_classification(
    num_classes: int,
    classifier_in_dim: int = 768,
    classifier_hidden_sizes: Union[int, Sequence[int]] = 768,
    classifier_dropout: float = 0.5,
    classifier_activation: Union[str, Callable] = "relu",
    classifier_normalization: Optional[Callable[[int], nn.Module]] = None,
    loss_fn: Optional[Callable] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
    param_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    **flava_model_kwargs: Any,
) -> FLAVAForClassification:
    """``FLAVAForClassification`` with random weights from ``seed``: an MLP
    head (``classifier_hidden_sizes``, ReLU, dropout) over the multimodal
    CLS token."""

    def build():
        classifier = MLP(in_dim=classifier_in_dim, out_dim=num_classes,
                         hidden_dims=classifier_hidden_sizes, dropout=classifier_dropout,
                         activation=classifier_activation,
                         normalization=classifier_normalization)
        return FLAVAForClassification(model=_flava_model(dtype=dtype, **flava_model_kwargs),
                                      classifier=classifier, loss_fn=loss_fn)

    return _built(build, device, dtype, param_dtype, seed)
