"""Bounding-box layout tokens (port of ``sd_tpu/data/layout.py``): the
tokenizer that the tiled ``coordinates_bbox`` route of
``LatentDiffusion.apply_model`` re-tokenizes each patch's crop with, and
the layout's rendering for image logs.

Each object is ``[class token, x0, y0, x1, y1]`` with the coordinates
quantized to ``n_bins`` bins, flattened into one sequence padded to
``max_objects`` objects. Token space: ``[0, n_bins)`` coordinate bins,
``[n_bins, n_bins + n_classes)`` classes, then the pad id. The layout
datasets that feed it (``ldm.data.openimages.OpenImagesBBox*``) are in
neither the reference repository nor ``sd_tpu``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["BBoxTokenizer", "plot_bboxes"]


class BBoxTokenizer:
    """``(class_id, x0, y0, x1, y1)`` lists → int32 token sequences."""

    def __init__(self, n_classes: int, n_bins: int = 256, max_objects: int = 15):
        self.n_classes = n_classes
        self.n_bins = n_bins
        self.max_objects = max_objects
        self.pad_id = n_bins + n_classes

    @property
    def vocab_size(self) -> int:
        return self.n_bins + self.n_classes + 1

    @property
    def seq_len(self) -> int:
        return self.max_objects * 5

    def _quantize(self, v: float) -> int:
        return int(np.clip(v, 0.0, 1.0) * (self.n_bins - 1) + 0.5)

    def encode(self, objects: Sequence[Tuple]) -> np.ndarray:
        """One layout → ``[seq_len]`` int32 ids; objects past
        ``max_objects`` are dropped."""
        ids: List[int] = []
        for cls, x0, y0, x1, y1 in list(objects)[: self.max_objects]:
            ids.append(self.n_bins + int(cls))
            ids.extend(self._quantize(v) for v in (x0, y0, x1, y1))
        out = np.full((self.seq_len,), self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out

    def crop_encoder(self, bbox: Tuple[float, float, float, float]) -> np.ndarray:
        """A crop ``(x_tl, y_tl, w, h)`` in [0, 1] → its 2-token code: the
        quantized top-left corner in the coordinate bins (the crop's size is
        the same for every patch of a grid)."""
        x_tl, y_tl, _, _ = bbox
        return np.array([self._quantize(x_tl), self._quantize(y_tl)], np.int32)

    def decode(self, ids: np.ndarray) -> List[Tuple]:
        """Ids → ``(class_id, x0, y0, x1, y1)`` objects up to the first pad."""
        objs = []
        ids = np.asarray(ids).reshape(-1)
        for i in range(0, len(ids) - 4, 5):
            if ids[i] == self.pad_id:
                break
            cls = int(ids[i]) - self.n_bins
            coords = [float(ids[i + 1 + j]) / (self.n_bins - 1) for j in range(4)]
            objs.append((cls, *coords))
        return objs

    def __call__(self, batch_objects, context_length=None) -> np.ndarray:
        return np.stack([self.encode(o) for o in batch_objects])


def plot_bboxes(objects: Sequence[Tuple], size: int = 256) -> np.ndarray:
    """A layout drawn as ``[size, size, 3]`` float32 in [-1, 1]: each box's
    outline and class id in a colour seeded by its class, on white."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size), color="white")
    draw = ImageDraw.Draw(img)
    for cls, x0, y0, x1, y1 in objects:
        color = tuple(int(c) for c in np.random.default_rng(int(cls)).integers(0, 200, 3))
        draw.rectangle([x0 * size, y0 * size, x1 * size, y1 * size], outline=color, width=2)
        draw.text((x0 * size + 2, y0 * size + 2), str(int(cls)), fill=color)
    return np.asarray(img).astype(np.float32) / 127.5 - 1.0
