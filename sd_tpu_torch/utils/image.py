"""Images on the host (port of ``sd_tpu/utils/image.py``): PNG files
(``save_image``, ``load_image``), grids, captions rendered as images for
the image logger (``text_to_image``) and a one-hot segmentation map's
colouring (``segmentation_to_rgb``). PIL is imported where it is used."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["save_image", "load_image", "make_grid", "save_grid", "text_to_image",
           "segmentation_to_rgb"]


def save_image(img: np.ndarray, path: str) -> None:
    """Write one uint8 ``[H, W, 3]`` image (PNG by the path's suffix)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.asarray(img)).save(path)


def load_image(path: str) -> np.ndarray:
    """A file's image as uint8 ``[H, W, 3]`` RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


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


def text_to_image(wh, captions: Sequence[str]) -> np.ndarray:
    """Captions drawn in black on white ``(w, h)`` images, wrapped every
    ``40 w / 256`` characters in PIL's default font: ``[B, h, w, 3]`` float32
    in [-1, 1]. A caption the font cannot encode leaves its image blank."""
    from PIL import Image, ImageDraw, ImageFont

    w, h = wh
    out = []
    for cap in captions:
        img = Image.new("RGB", (w, h), color="white")
        draw = ImageDraw.Draw(img)
        font = ImageFont.load_default()
        nc = max(int(40 * (w / 256)), 1)
        lines = "\n".join(cap[s:s + nc] for s in range(0, len(cap), nc))
        try:
            draw.text((0, 0), lines, fill="black", font=font)
        except UnicodeEncodeError:
            pass
        out.append(np.asarray(img).astype(np.float32) / 127.5 - 1.0)
    return np.stack(out)


def segmentation_to_rgb(x, seed: int = 0) -> np.ndarray:
    """A one-hot segmentation map ``[..., n_labels]`` coloured by a fixed
    random projection to 3 channels, then min-max rescaled to [-1, 1]. The
    projection is drawn from ``default_rng(seed * 100003 + n_labels)``, so
    every call colours alike."""
    x = np.asarray(x, dtype=np.float32)
    nl = x.shape[-1]
    rng = np.random.default_rng(seed * 100003 + nl)
    w = rng.standard_normal((nl, 3)).astype(np.float32)
    y = x @ w
    lo, hi = y.min(), y.max()
    return 2.0 * (y - lo) / max(hi - lo, 1e-12) - 1.0
