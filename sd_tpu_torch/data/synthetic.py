"""Synthetic images with captions, and colored shapes by class (port of
``SyntheticImages`` and ``ColoredShapes`` from ``sd_tpu/data/synthetic.py``):
the data of training runs where no dataset is present. Real SD weights and
datasets are not in the repository.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sd_tpu_torch.data.base import Dataset

__all__ = ["SyntheticImages", "ColoredShapes"]


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


class ColoredShapes(Dataset):
    """A learnable class-conditional toy distribution for the convergence
    configs: one colored shape on a dark background, ``class_label`` =
    (shape, color) with ``shape = label % 4`` (square, circle, upward
    triangle, plus) and ``color = label // 4`` (red, blue, green, yellow),
    the center jittered by up to ``jitter`` pixels from
    ``default_rng(seed * 100003 + i)``."""

    _COLORS = np.array([[1.0, -0.6, -0.6], [-0.6, 0.2, 1.0], [-0.4, 1.0, -0.4],
                        [1.0, 0.9, -0.7]], np.float32)

    def __init__(self, size: int = 32, length: int = 2048, n_classes: int = 8,
                 jitter: int = 4, radius: int = 7, seed: int = 0):
        if n_classes > 4 * len(self._COLORS):
            raise ValueError(f"n_classes <= {4 * len(self._COLORS)}")
        self.size = size
        self.length = length
        self.n_classes = n_classes
        self.jitter = jitter
        self.radius = radius
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        label = i % self.n_classes
        shape, color = label % 4, self._COLORS[label // 4]
        c = self.size // 2 + rng.integers(-self.jitter, self.jitter + 1, 2)
        yy, xx = np.mgrid[0:self.size, 0:self.size]
        dy, dx = yy - c[0], xx - c[1]
        r = self.radius
        if shape == 0:
            mask = np.maximum(np.abs(dx), np.abs(dy)) < r
        elif shape == 1:
            mask = dx * dx + dy * dy < r * r
        elif shape == 2:
            mask = (dy > -r) & (dy < r) & (np.abs(dx) < (dy + r) / 2)
        else:
            arm = max(r // 3, 2)
            mask = ((np.abs(dx) < arm) | (np.abs(dy) < arm)) & (
                np.maximum(np.abs(dx), np.abs(dy)) < r)
        img = np.full((self.size, self.size, 3), -0.95, np.float32)
        img[mask] = color
        return {"image": img, "class_label": np.int32(label)}
