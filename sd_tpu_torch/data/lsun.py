"""LSUN filelist datasets (a copy of ``sd_tpu/data/lsun.py``, which holds
no JAX): the reference's ``ldm/data/lsun.py``.

Each item is the image named by a line of ``txt_file`` under ``data_root``,
center-cropped to a square, resized with PIL, flipped left to right with
probability ``flip_p`` (a draw of the dataset's own generator, seeded by
``seed``) and scaled to float32 [-1, 1] under ``"image"``. The six
churches/bedrooms/cats x train/validation variants default to the
reference's filelist paths.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from sd_tpu_torch.data.base import Dataset

__all__ = [
    "load_rgb", "center_crop_square", "resize", "LSUNBase",
    "LSUNChurchesTrain", "LSUNChurchesValidation",
    "LSUNBedroomsTrain", "LSUNBedroomsValidation",
    "LSUNCatsTrain", "LSUNCatsValidation",
]

_PIL_INTERP = {"linear": "bilinear", "bilinear": "bilinear",
               "bicubic": "bicubic", "lanczos": "lanczos"}


def load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img).astype(np.uint8)


def center_crop_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    crop = min(h, w)
    return img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]


def resize(img: np.ndarray, size: int, interpolation: str = "bicubic") -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(img)
    resample = getattr(Image, _PIL_INTERP.get(interpolation, "bicubic").upper())
    return np.asarray(pil.resize((size, size), resample=resample)).astype(np.uint8)


class LSUNBase(Dataset):
    def __init__(self, txt_file: str, data_root: str, size: Optional[int] = None,
                 interpolation: str = "bicubic", flip_p: float = 0.5, seed: int = 0):
        with open(txt_file) as f:
            self.image_paths = f.read().splitlines()
        self.data_root = data_root
        self.size = size
        self.interpolation = interpolation
        self.flip_p = flip_p
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> Dict:
        rel = self.image_paths[i]
        path = os.path.join(self.data_root, rel)
        img = center_crop_square(load_rgb(path))
        if self.size is not None:
            img = resize(img, self.size, self.interpolation)
        if self._rng.random() < self.flip_p:
            img = img[:, ::-1]
        return {
            "relative_file_path_": rel,
            "file_path_": path,
            "image": (img / 127.5 - 1.0).astype(np.float32),
        }


def _variant(name, txt, root, flip=0.5):
    class _DS(LSUNBase):
        def __init__(self, **kwargs):
            kwargs.setdefault("txt_file", txt)
            kwargs.setdefault("data_root", root)
            kwargs.setdefault("flip_p", flip)
            super().__init__(**kwargs)

    _DS.__name__ = name
    return _DS


LSUNChurchesTrain = _variant("LSUNChurchesTrain", "data/lsun/church_outdoor_train.txt",
                             "data/lsun/churches")
LSUNChurchesValidation = _variant("LSUNChurchesValidation", "data/lsun/church_outdoor_val.txt",
                                  "data/lsun/churches", flip=0.0)
LSUNBedroomsTrain = _variant("LSUNBedroomsTrain", "data/lsun/bedrooms_train.txt",
                             "data/lsun/bedrooms")
LSUNBedroomsValidation = _variant("LSUNBedroomsValidation", "data/lsun/bedrooms_val.txt",
                                  "data/lsun/bedrooms", flip=0.0)
LSUNCatsTrain = _variant("LSUNCatsTrain", "data/lsun/cat_train.txt", "data/lsun/cats")
LSUNCatsValidation = _variant("LSUNCatsValidation", "data/lsun/cat_val.txt", "data/lsun/cats",
                              flip=0.0)
