"""Synthetic images with captions (port of ``SyntheticImages`` from
``sd_tpu/data/synthetic.py``): the data of training runs where no dataset is
present. Real SD weights and datasets are not in the repository.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sd_tpu_torch.data.base import Dataset

__all__ = ["SyntheticImages"]


class SyntheticImages(Dataset):
    """Deterministic random images in [-1, 1], class labels and token
    captions: ``caption_tokens`` int32 ids under ``caption_key`` (SD v1's
    ``cond_stage_key`` is ``"txt"``: 77 ids). Item ``i`` is drawn from
    ``default_rng(seed * 100003 + i)``, as in ``sd_tpu``; its string-caption
    mode has no caller here.
    """

    def __init__(self, size: int = 32, length: int = 64, channels: int = 3,
                 n_classes: int = 10, caption_tokens: int = 8,
                 caption_vocab: int = 64, seed: int = 0, caption_key: str = "caption"):
        self.size = size
        self.length = length
        self.channels = channels
        self.n_classes = n_classes
        self.caption_tokens = caption_tokens
        self.caption_vocab = caption_vocab
        self.seed = seed
        self.caption_key = caption_key

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        img = rng.uniform(-1, 1, (self.size, self.size, self.channels))
        caption = rng.integers(0, self.caption_vocab, (self.caption_tokens,)).astype(np.int32)
        return {"image": img.astype(np.float32), "class_label": np.int32(i % self.n_classes),
                self.caption_key: caption}
