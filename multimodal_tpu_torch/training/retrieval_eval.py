"""Cross-modal retrieval: Recall@k over a similarity matrix whose target
is the diagonal. Counterpart of ``multimodal_tpu/training/retrieval_eval.py``.
The arithmetic is fp32 on the embeddings' device; ``chunk_size`` streams
the query rows for galleries whose (n, n) matrix does not fit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def _ranks(q: torch.Tensor, g: torch.Tensor, start: int) -> torch.Tensor:
    """Each query row's target rank: the count of strictly larger scores."""
    sim = q @ g.T
    target = torch.arange(start, start + q.shape[0], device=q.device)
    target_score = sim.gather(1, target[:, None])
    return (sim > target_score).sum(dim=1)


def retrieval_recall_at_k(
    embeddings_a: torch.Tensor,
    embeddings_b: torch.Tensor,
    ks: Sequence[int] = (1, 5, 10),
    normalize: bool = True,
    chunk_size: Optional[int] = None,
) -> Dict[str, float]:
    """Recall@k of a -> b (rows of ``a @ b.T``) and b -> a with diagonal
    ground truth: ``{"a2b_recall_{k}", "b2a_recall_{k}"}``."""
    if embeddings_a.shape[0] != embeddings_b.shape[0]:
        raise ValueError("paired retrieval eval needs equal counts")
    a = torch.as_tensor(embeddings_a).float()
    b = torch.as_tensor(embeddings_b).float().to(a.device)
    if normalize:
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(1e-12)
        b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(1e-12)
    ks = tuple(int(k) for k in ks)
    n = a.shape[0]
    step = chunk_size or max(n, 1)

    def direction(q, g):
        ranks = torch.cat([_ranks(q[s:s + step], g, s) for s in range(0, n, step)])
        if chunk_size is None:  # an fp32 mean, as the JAX function takes it
            return {k: float((ranks < k).float().mean()) for k in ks}
        return {k: float((ranks < k).sum()) / n for k in ks}

    a2b, b2a = direction(a, b), direction(b, a)
    out: Dict[str, float] = {}
    for k in ks:
        out[f"a2b_recall_{k}"] = a2b[k]
        out[f"b2a_recall_{k}"] = b2a[k]
    return out
