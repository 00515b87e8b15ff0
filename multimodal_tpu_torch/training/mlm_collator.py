"""Masked-language-modeling collation. A numpy copy of
``multimodal_tpu/training/mlm_collator.py``: BERT-style 80/10/10 masking
producing ``(masked_ids, labels)`` with ``ignore_index`` on unmasked
positions, and a whole-word variant that masks WordPiece continuations with
their word. It draws from its ``np.random.RandomState`` in the same order as
the JAX package's, so one seed gives the same batches in both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class MLMCollator:
    def __init__(
        self,
        vocab_size: int,
        mask_token_id: int,
        mlm_probability: float = 0.15,
        special_token_ids: Sequence[int] = (0,),
        ignore_index: int = -100,
        whole_word_mask: bool = False,
        subword_prefix_ids: Optional[Sequence[int]] = None,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.vocab_size = vocab_size
        self.mask_token_id = mask_token_id
        self.mlm_probability = mlm_probability
        self.special = set(special_token_ids)
        self.ignore_index = ignore_index
        self.whole_word_mask = whole_word_mask
        self.subword_prefix = set(subword_prefix_ids or [])
        self.rng = rng or np.random.RandomState()

    def _candidate_mask(self, ids: np.ndarray) -> np.ndarray:
        special = np.isin(ids, list(self.special))
        probs = self.rng.rand(*ids.shape)
        mask = (probs < self.mlm_probability) & ~special
        if self.whole_word_mask and self.subword_prefix:
            # extend each mask onto following subword-continuation tokens
            is_cont = np.isin(ids, list(self.subword_prefix))
            for b in range(ids.shape[0]):
                for i in range(1, ids.shape[1]):
                    if is_cont[b, i] and mask[b, i - 1]:
                        mask[b, i] = True
        return mask

    def __call__(self, input_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(b, s) token ids -> (masked_ids, labels)."""
        ids = np.asarray(input_ids)
        mask = self._candidate_mask(ids)
        labels = np.where(mask, ids, self.ignore_index)

        masked = ids.copy()
        decide = self.rng.rand(*ids.shape)
        # 80% -> [MASK]
        replace_mask = mask & (decide < 0.8)
        masked[replace_mask] = self.mask_token_id
        # 10% -> random token
        random_mask = mask & (decide >= 0.8) & (decide < 0.9)
        masked[random_mask] = self.rng.randint(
            0, self.vocab_size, size=int(random_mask.sum())
        )
        # remaining 10% keep original
        return masked, labels
