"""ALBEF task models: VQA (answer decoding) and retrieval. Counterpart of
``multimodal_tpu/examples/albef/model.py`` (``PredictionHead``,
``ALBEFDecoder``, ``ALBEFModelForVQA``, ``ALBEFModelForRetrieval``,
``albef_retrieval_train_step``, ``retrieval_rerank``).

The retrieval step returns the ITC + ITM loss and moves the momentum copy
and the queues in place (``models/albef/model.py``). ``vqa_answer_loss``
composes the VQA model's parts as the reference's VQA fine-tuning does: the
question fused once, its states repeated for each of its answers (only the
real ones, not the padding rows), the decoder, the CLM loss weighted by the
answers' weights.

The decoder follows the JAX package: its self-attention takes the answers'
padding mask alone, so a position attends to the answer tokens after it
(``multimodal_tpu/examples/albef/model.py:97-106``; the reference uses a
causal mask; ROADMAP.md, section C).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.albef.model import (
    ALBEFModel,
    ALBEFModelWithSimilarity,
    ALBEFQueues,
    albef_with_similarity_forward,
)
from multimodal_tpu_torch.models.albef.multimodal_encoder import ALBEFMultimodalEncoder
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.text_embedding import BERTTextEmbeddings
from multimodal_tpu_torch.modules.losses.albef import (
    causal_language_modeling_loss,
    image_text_contrastive_loss,
)


class PredictionHead(nn.Module):
    """dense -> GELU (tanh form, ``jax.nn.gelu``'s default) -> fp32 LN ->
    vocabulary decoder, in the input's dtype."""

    def __init__(self, vocab_size: int, hidden_size: int = 768):
        super().__init__()
        self.transform = nn.Linear(hidden_size, hidden_size)
        self.layer_norm = Fp32LayerNorm(hidden_size, eps=1e-12)
        self.decoder = nn.Linear(hidden_size, vocab_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(self.transform, hidden_states, hidden_states.dtype),
                   approximate="tanh")
        return dense(self.decoder, self.layer_norm(h), hidden_states.dtype)


class ALBEFDecoder(nn.Module):
    """Text embeddings + the cross-attention stack + the prediction head:
    answers decoded against the question's fused states. ``dtype`` is the
    compute dtype (None: the weights')."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_hidden_layers: int = 6, num_attention_heads: int = 12,
                 intermediate_size: int = 3072, max_position_embeddings: int = 512,
                 pad_token_id: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embeddings = BERTTextEmbeddings(
            hidden_size=hidden_size, vocab_size=vocab_size, pad_token_id=pad_token_id,
            max_position_embeddings=max_position_embeddings, dtype=dtype)
        self.encoder = ALBEFMultimodalEncoder(
            hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads, intermediate_size=intermediate_size)
        self.head = PredictionHead(vocab_size, hidden_size)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                encoder_hidden_states: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        emb = self.embeddings(input_ids=input_ids, deterministic=deterministic)
        hidden = self.encoder(emb, attention_mask=attention_mask,
                              encoder_hidden_states=encoder_hidden_states,
                              deterministic=deterministic)
        return self.head(hidden)


class ALBEFModelForVQA(nn.Module):
    """Question fusing (``model``) and answer decoding (``decoder``)."""

    def __init__(self, model: ALBEFModel, decoder: ALBEFDecoder):
        super().__init__()
        self.model = model
        self.decoder = decoder

    def encode_question(self, image: torch.Tensor, question: torch.Tensor,
                        question_atts: torch.Tensor, deterministic: bool = True
                        ) -> torch.Tensor:
        return self.model(image, question, question_atts, deterministic)[2]

    def forward(self, image: torch.Tensor, question: torch.Tensor, question_atts: torch.Tensor,
                answer: torch.Tensor, answer_atts: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """The CLM loss of each sample's answer, ``(batch,)``."""
        fused = self.encode_question(image, question, question_atts, deterministic)
        scores = self.decoder(answer, answer_atts, fused, deterministic=deterministic)
        labels = torch.where(answer_atts.bool(), answer, -100)
        return causal_language_modeling_loss(labels, scores)


def vqa_answer_loss(model: ALBEFModelForVQA, image: torch.Tensor, question: torch.Tensor,
                    question_atts: torch.Tensor, answers: torch.Tensor,
                    answer_atts: torch.Tensor, answer_weights: torch.Tensor,
                    answer_counts=None, deterministic: bool = True) -> torch.Tensor:
    """A VQA training batch's loss (``VQADataModule``'s train fields:
    ``answers (b, A, L)``, ``answer_weights (b, A)``, ``answer_counts
    (b,)``): each question fused once, its states repeated for its answers,
    the answers decoded, their CLM losses weighted by ``answer_weights``,
    summed and divided by the batch size, as the reference's VQA fine-tuning
    takes it. Only the first ``answer_counts[i]`` rows of question ``i`` are
    decoded (None: all A); the counts are read on the host, so a CPU tensor
    or a list costs no device sync. Rows past a count have weight 0, so the
    loss is the one of decoding every row."""
    b, n_ans, length = answers.shape
    counts = torch.as_tensor(n_ans if answer_counts is None else answer_counts,
                             dtype=torch.long, device="cpu").expand(b)
    # each decoded row's question, and its row among the b x A, built on the host
    owner = torch.repeat_interleave(torch.arange(b), counts)
    first = torch.cumsum(counts, 0) - counts
    rows_at = owner * n_ans + torch.arange(len(owner)) - first[owner]
    owner, rows_at = (t.to(answers.device, non_blocking=True) for t in (owner, rows_at))
    fused = model.encode_question(image, question, question_atts, deterministic)
    fused = fused.index_select(0, owner)
    rows = answers.reshape(b * n_ans, length).index_select(0, rows_at)
    atts = answer_atts.reshape(b * n_ans, length).index_select(0, rows_at)
    scores = model.decoder(rows, atts, fused, deterministic=deterministic)
    labels = torch.where(atts.bool(), rows, -100)
    loss = causal_language_modeling_loss(labels, scores)
    weights = answer_weights.reshape(-1).index_select(0, rows_at)
    return (weights.float() * loss).sum() / b


class ALBEFModelForRetrieval(nn.Module):
    """ALBEF with similarity and the ITM head (``itm_head``, 2 classes, in
    fp32)."""

    def __init__(self, model_with_similarity: ALBEFModelWithSimilarity, hidden_size: int = 768):
        super().__init__()
        self.model_with_similarity = model_with_similarity
        self.itm_head = nn.Linear(hidden_size, 2)

    def itm_scores(self, multimodal_cls: torch.Tensor) -> torch.Tensor:
        return self.itm_head(multimodal_cls.float())


def albef_retrieval_train_step(
    model: ALBEFModelForRetrieval,
    model_m: nn.Module,
    queues: ALBEFQueues,
    image: torch.Tensor,
    text: torch.Tensor,
    text_atts: torch.Tensor,
    idx: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    alpha: float = 0.4,
    group=None,
) -> torch.Tensor:
    """The ITC + ITM loss of one retrieval batch. ``model_m`` is the
    momentum copy of ``model.model_with_similarity``; it and ``queues`` move
    in place. The forwards are deterministic, as the JAX step's."""
    out = albef_with_similarity_forward(model.model_with_similarity, model_m, queues, image,
                                        text, text_atts, idx, generator, deterministic=True,
                                        group=group)
    s = out.similarity
    itc = image_text_contrastive_loss(s.sim_i2t, s.sim_t2i, s.sim_i2t_m, s.sim_t2i_m,
                                      out.sim_targets, alpha=alpha)
    pos = out.multimodal_embeddings[:, 0]
    neg = out.multimodal_embeddings_neg[:, 0]
    logits = model.itm_scores(torch.cat([pos, neg], dim=0))
    labels = torch.cat([torch.ones(pos.shape[0], dtype=torch.long, device=logits.device),
                        torch.zeros(neg.shape[0], dtype=torch.long, device=logits.device)])
    itm = F.cross_entropy(logits.float(), labels)
    return itc + itm


def retrieval_rerank(sim_matrix: torch.Tensor,
                     itm_score_fn: Callable[[int, torch.Tensor], torch.Tensor],
                     k_test: int = 16) -> torch.Tensor:
    """Two-stage retrieval scores: each row's top ``k_test`` ITC candidates
    (ties to the lower index) take ``itm_score_fn(row, candidates)``'s
    ``(k_test,)`` matching scores, every other entry ``-inf``."""
    topk_idx = torch.argsort(-sim_matrix, dim=1, stable=True)[:, :k_test]
    scores = torch.full_like(sim_matrix, -torch.inf)
    for i in range(sim_matrix.shape[0]):
        scores[i, topk_idx[i]] = itm_score_fn(i, topk_idx[i]).to(scores.dtype)
    return scores
