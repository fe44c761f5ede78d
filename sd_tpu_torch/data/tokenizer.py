"""The vocabulary-free hash tokenizer (a copy of ``HashTokenizer`` and the
text cleanup it uses, from ``sd_tpu/data/tokenizer.py``).

Deterministic word-hash ids with CLIP's call contract: ``<|startoftext|>``
and ``<|endoftext|>`` at the two top ids, padded with the end id to
``context_length``. It lets the pipelines and the trainer run where no BPE
vocabulary is present; it is not compatible with released checkpoints'
embeddings.
"""

from __future__ import annotations

import hashlib
import html
from typing import List

import numpy as np

__all__ = ["HashTokenizer"]


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


class HashTokenizer:
    """``tok(texts, context_length=77)`` → int32 ids ``[len(texts), context_length]``."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _clean(text).split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.eot_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)[: context_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out
