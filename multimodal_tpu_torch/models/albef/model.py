"""ALBEF with momentum encoders and feature queues. Counterpart of
``multimodal_tpu/models/albef/model.py`` (``ALBEFOutput``, ``ALBEFSimilarity``,
``ALBEFWithSimilarityOutput``, ``ALBEFQueues``, ``init_albef_queues``,
``ALBEFModel``, ``albef_forward_with_momentum``, ``ALBEFModelWithSimilarity``,
``albef_with_similarity_forward``).

State: the JAX package threads a momentum parameter tree and a queue tuple
through pure functions; here the momentum model is a second module whose
parameters are buffers (``utils/common.py:momentum_copy``), moved by
``momentum_update`` under ``torch.no_grad()``, and the queues are buffers of
an ``ALBEFQueues`` module written in place at the ring pointer. The
forwards keep the JAX function's order: the EMA update first, then the
grad-path and momentum forwards, the targets from ids, the similarities
against ``[momentum features ; queue]``, the enqueue, the hard negatives.

The enqueue writes the queues only after the similarities have read them,
and those read ``torch.cat`` copies, so the write changes no tensor that
autograd saved. The hard negatives (:func:`hard_negative_indices`) draw with
``torch.multinomial`` from an explicit generator, where the JAX package draws
with ``jax.random.categorical``: the same distribution, other draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.parallel.collectives import (
    BackpropType,
    all_gather_with_backprop_type,
)
from multimodal_tpu_torch.utils.common import momentum_update
from multimodal_tpu_torch.utils.device import resolve_device


class ALBEFOutput(NamedTuple):
    image_embeddings: Optional[torch.Tensor] = None
    image_embeddings_m: Optional[torch.Tensor] = None
    text_embeddings: Optional[torch.Tensor] = None
    text_embeddings_m: Optional[torch.Tensor] = None
    multimodal_embeddings: Optional[torch.Tensor] = None
    multimodal_embeddings_m: Optional[torch.Tensor] = None


class ALBEFSimilarity(NamedTuple):
    sim_i2t: torch.Tensor
    sim_t2i: torch.Tensor
    sim_i2t_m: torch.Tensor
    sim_t2i_m: torch.Tensor


class ALBEFWithSimilarityOutput(NamedTuple):
    image_embeddings: torch.Tensor
    text_embeddings: torch.Tensor
    multimodal_embeddings: torch.Tensor
    multimodal_embeddings_neg: torch.Tensor
    similarity: ALBEFSimilarity
    sim_targets: torch.Tensor


class ALBEFQueues(nn.Module):
    """Ring buffers of recent momentum features: ``image_queue`` and
    ``text_queue`` ``(embed_size, queue_size)`` fp32, ``idx_queue`` ``(1,
    queue_size)`` int64 and ``queue_ptr`` a scalar int64, all buffers,
    written in place by :func:`albef_with_similarity_forward`."""

    def __init__(self, image_queue: torch.Tensor, text_queue: torch.Tensor,
                 idx_queue: torch.Tensor, queue_ptr: Union[int, torch.Tensor] = 0):
        super().__init__()
        self.register_buffer("image_queue", image_queue.float())
        self.register_buffer("text_queue", text_queue.float())
        self.register_buffer("idx_queue", idx_queue.long())
        self.register_buffer("queue_ptr", torch.as_tensor(queue_ptr, dtype=torch.long,
                                                          device=image_queue.device))


def init_albef_queues(embed_size: int = 256, queue_size: int = 65536,
                      mask_token_id: int = -100, generator: Optional[torch.Generator] = None,
                      device: Optional[Union[str, torch.device]] = None) -> ALBEFQueues:
    """Queues of unit columns drawn from ``generator`` (a CPU generator
    seeded 0 by default; the draw runs on the generator's device), ids
    ``mask_token_id``, the pointer at 0, on ``device`` (CUDA unless ``"cpu"``
    is given)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draw = [torch.randn((embed_size, queue_size), generator=generator, device=generator.device)
            for _ in range(2)]
    img, txt = (q / torch.linalg.vector_norm(q, dim=0, keepdim=True) for q in draw)
    idx = torch.full((1, queue_size), mask_token_id, dtype=torch.long)
    return ALBEFQueues(img.to(dev), txt.to(dev), idx.to(dev), torch.zeros((), dtype=torch.long,
                                                                          device=dev))


class ALBEFModel(nn.Module):
    """The grad-path trio: vision, text and cross-attention multimodal
    encoders."""

    def __init__(self, vision_encoder: nn.Module, text_encoder: nn.Module,
                 multimodal_encoder: nn.Module, momentum: float = 0.995):
        super().__init__()
        self.vision_encoder = vision_encoder
        self.text_encoder = text_encoder
        self.multimodal_encoder = multimodal_encoder
        self.momentum = momentum

    def forward(self, image: torch.Tensor, text: torch.Tensor, text_atts: torch.Tensor,
                deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        image_embeds = self.vision_encoder(image, deterministic=deterministic)
        text_embeds = self.text_encoder(input_ids=text, attention_mask=text_atts,
                                        deterministic=deterministic).last_hidden_state
        multimodal = self.multimodal_encoder(hidden_states=text_embeds,
                                             attention_mask=text_atts,
                                             encoder_hidden_states=image_embeds,
                                             deterministic=deterministic)
        return image_embeds, text_embeds, multimodal

    def encode_multimodal(self, text_embeds: torch.Tensor, text_atts: torch.Tensor,
                          image_embeds: torch.Tensor, deterministic: bool = True
                          ) -> torch.Tensor:
        return self.multimodal_encoder(hidden_states=text_embeds, attention_mask=text_atts,
                                       encoder_hidden_states=image_embeds,
                                       deterministic=deterministic)


def albef_forward_with_momentum(model: ALBEFModel, model_m: nn.Module, image: torch.Tensor,
                                text: torch.Tensor, text_atts: torch.Tensor,
                                deterministic: bool = False) -> ALBEFOutput:
    """One ALBEF forward: the grad path, the EMA update of ``model_m`` (a
    momentum copy of ``model``) in place, and its forward without
    gradients."""
    img, txt, mm = model(image, text, text_atts, deterministic=deterministic)
    momentum_update(model, model_m, model.momentum)
    with torch.no_grad():
        img_m, txt_m, mm_m = model_m(image, text, text_atts, deterministic=True)
    return ALBEFOutput(img, img_m, txt, txt_m, mm, mm_m)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class ALBEFModelWithSimilarity(nn.Module):
    """ALBEF with the 768 -> ``embed_size`` projections and the learned
    temperature ``temp``. The projections run in fp32 (the CLS rows are cast
    up), as the JAX module's fp32 ``nn.Dense`` promotes them; the momentum
    state lives outside (:func:`albef_with_similarity_forward`)."""

    def __init__(self, albef_model: ALBEFModel, vision_proj: nn.Module, text_proj: nn.Module,
                 embed_size: int = 256, queue_size: int = 65536, mask_token_id: int = -100,
                 temp: float = 0.07):
        super().__init__()
        self.albef_model = albef_model
        self.vision_proj = vision_proj
        self.text_proj = text_proj
        self.embed_size = embed_size
        self.queue_size = queue_size
        self.mask_token_id = mask_token_id
        self.temp = nn.Parameter(torch.tensor(temp, dtype=torch.float32))

    def project_features(self, image_embeds: torch.Tensor, text_embeds: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        image_feat = _unit(self.vision_proj(image_embeds[:, 0, :].float()))
        text_feat = _unit(self.text_proj(text_embeds[:, 0, :].float()))
        return image_feat, text_feat

    def forward(self, image: torch.Tensor, text: torch.Tensor, text_atts: torch.Tensor,
                deterministic: bool = True):
        img, txt, mm = self.albef_model(image, text, text_atts, deterministic)
        return img, txt, mm, self.project_features(img, txt)


def hard_negative_indices(sim_i2t: torch.Tensor, sim_t2i: torch.Tensor,
                          generator: Optional[torch.Generator] = None, offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch hard negatives: for each text an image index drawn with
    probability ``softmax`` of its row of ``sim_t2i`` (batch columns) less
    the diagonal, then for each image a text index likewise from
    ``sim_i2t``. Never the diagonal, which sits at column ``offset + row``
    (a rank's rows against the gathered batch). ``(neg_img_idx,
    neg_txt_idx)``. ALBEF's and BLIP-2's ITM draw both."""
    rows, cols = sim_i2t.shape
    if cols < 2:
        raise ValueError("hard negatives need a batch of at least 2")
    dev = sim_i2t.device
    diag = (torch.arange(cols, device=dev)[None, :]
            == torch.arange(rows, device=dev)[:, None] + offset)

    def draw(sim):
        w = F.softmax(sim.detach().float().masked_fill(diag, -torch.inf), dim=1)
        return torch.multinomial(w, 1, generator=generator)[:, 0]

    return draw(sim_t2i), draw(sim_i2t)


@torch.no_grad()
def _enqueue(queues: ALBEFQueues, image_feat: torch.Tensor, text_feat: torch.Tensor,
             idx: torch.Tensor, queue_size: int) -> None:
    """Writes the batch's momentum features and ids at the ring pointer and
    advances it, in place and on the device (no host read of the
    pointer)."""
    bsz = image_feat.shape[0]
    if queue_size % bsz != 0:
        raise ValueError("queue_size should be divisible by batch_size")
    cols = queues.queue_ptr + torch.arange(bsz, device=image_feat.device)
    queues.image_queue.index_copy_(1, cols, image_feat.T.to(queues.image_queue.dtype))
    queues.text_queue.index_copy_(1, cols, text_feat.T.to(queues.text_queue.dtype))
    queues.idx_queue.index_copy_(1, cols, idx.T.to(queues.idx_queue.dtype))
    queues.queue_ptr.add_(bsz).remainder_(queue_size)


def albef_with_similarity_forward(
    module: ALBEFModelWithSimilarity,
    module_m: nn.Module,
    queues: ALBEFQueues,
    image: torch.Tensor,
    text: torch.Tensor,
    text_atts: torch.Tensor,
    idx: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
    group=None,
) -> ALBEFWithSimilarityOutput:
    """One ALBEF-with-similarity forward. Updates ``module_m`` (a momentum
    copy of ``module``) and ``queues`` in place; the negatives draw from
    ``generator`` (on the batch's device). ``group``: the process group the
    enqueue gathers over (none: this process alone)."""
    model = module.albef_model
    # 1) the EMA of every parameter, projections and temperature included
    momentum_update(module, module_m, model.momentum)

    # 2) the grad path and the momentum path (no gradients): the momentum
    # features need only the unimodal towers, so its multimodal encoder,
    # whose output the JAX step leaves unused, does not run
    img, txt, mm, (image_feat, text_feat) = module(image, text, text_atts, deterministic)
    with torch.no_grad():
        model_m = module_m.albef_model
        image_feat_m, text_feat_m = module_m.project_features(
            model_m.vision_encoder(image, deterministic=True),
            model_m.text_encoder(input_ids=text, attention_mask=text_atts,
                                 deterministic=True).last_hidden_state)
    temp = module.temp

    # 3) targets from id matches against the queue
    idx = idx.reshape(-1, 1).to(queues.idx_queue.device)
    idx_all = torch.cat([idx.T.to(queues.idx_queue.dtype), queues.idx_queue], dim=1)
    pos_idx = (idx == idx_all).float()
    sim_targets = pos_idx / pos_idx.sum(dim=1, keepdim=True)

    # 4) similarities against [momentum features ; queue], fp32
    image_feat_all = torch.cat([image_feat_m.T, queues.image_queue], dim=1)
    text_feat_all = torch.cat([text_feat_m.T, queues.text_queue], dim=1)
    sim_i2t = image_feat @ text_feat_all / temp
    sim_t2i = text_feat @ image_feat_all / temp
    with torch.no_grad():
        sim_i2t_m = image_feat_m @ text_feat_all / temp
        sim_t2i_m = text_feat_m @ image_feat_all / temp
    similarity = ALBEFSimilarity(sim_i2t, sim_t2i, sim_i2t_m, sim_t2i_m)

    # 5) enqueue (gathered over the group), after every read of the queues
    gather = lambda x: all_gather_with_backprop_type(x, group, BackpropType.NONE)  # noqa: E731
    _enqueue(queues, gather(image_feat_m), gather(text_feat_m), gather(idx), module.queue_size)

    # 6) in-batch hard negatives
    bs = image.shape[0]
    neg_img_idx, neg_txt_idx = hard_negative_indices(sim_i2t[:, :bs], sim_t2i[:, :bs],
                                                     generator)
    image_embeds_neg = img.index_select(0, neg_img_idx)
    text_embeds_neg = txt.index_select(0, neg_txt_idx)
    text_atts_neg = text_atts.index_select(0, neg_txt_idx)

    # 7) the negative pairs: (positive text, negative image), (negative text,
    # positive image)
    mm_neg = model.encode_multimodal(torch.cat([txt, text_embeds_neg], dim=0),
                                     torch.cat([text_atts, text_atts_neg], dim=0),
                                     torch.cat([image_embeds_neg, img], dim=0), deterministic)
    return ALBEFWithSimilarityOutput(image_embeddings=img, text_embeddings=txt,
                                     multimodal_embeddings=mm,
                                     multimodal_embeddings_neg=mm_neg,
                                     similarity=similarity, sim_targets=sim_targets)
