"""Image files on the host (``save_image``, ``make_grid`` and ``save_grid``
from ``sd_tpu/utils/image.py``). PIL is imported where a file is written."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["save_image", "make_grid", "save_grid"]


def save_image(img: np.ndarray, path: str) -> None:
    """Write one uint8 ``[H, W, 3]`` image (PNG by the path's suffix)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.asarray(img)).save(path)


def make_grid(images: np.ndarray, n_rows: int = 0) -> np.ndarray:
    """``[N, H, W, C]`` → one grid image, ``n_rows`` images a row (about
    sqrt(N) by default), the last row padded with black."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    cols = n_rows or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    pad = rows * cols - n
    if pad:
        images = np.concatenate([images, np.zeros((pad, h, w, c), images.dtype)])
    return images.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(
        rows * h, cols * w, c)


def save_grid(images: np.ndarray, path: str, n_rows: int = 0) -> None:
    save_image(make_grid(images, n_rows), path)
