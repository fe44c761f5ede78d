"""ImageNet datasets, their preparation and the super-resolution pairs (a
copy of ``sd_tpu/data/imagenet.py``, which holds no JAX): the reference's
``ldm/data/imagenet.py``.

- **Preparation**: :func:`prepare_imagenet_train` and
  :func:`prepare_imagenet_validation` extract the official tarballs into
  ``<root>/data/<synset>/*.JPEG`` (the train tar holds a tar per synset; the
  validation tar is flat and is sorted into synset folders by
  ``validation_synset.txt``), write the sorted ``filelist.txt`` and a ready
  marker, and do nothing the second time. They never fetch: a missing file
  raises :class:`DownloadRequired` with its name, size and the reference's
  source.
- **Metadata**: ``synset_human.txt`` gives ``human_label``;
  ``index_synset.yaml`` drives ``sub_indices`` and
  ``keep_orig_class_label``.
- **Datasets**: :class:`ImageNetTrain` / :class:`ImageNetValidation` yield
  ``image``, ``class_label``, ``synsets``, ``human_label`` and ``relpath``
  from a filelist; :class:`ImageNetSR` crops, resizes and degrades
  (``bsrgan``, ``bsrgan_light``, or a plain resize) into ``image`` and
  ``LR_image``, and its train and validation splits take the reference's
  HR-index pickles (``data/imagenet_{train,val}_hr_indices.p``) where given.

Every random draw (crops, degradation) comes from the dataset's own
``np.random.default_rng(seed)``, as in ``sd_tpu``.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
import tarfile
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np

from sd_tpu_torch.data.base import Dataset
from sd_tpu_torch.data.degradation import degradation_bsrgan, degradation_bsrgan_variant
from sd_tpu_torch.data.lsun import center_crop_square, load_rgb, resize

__all__ = [
    "DownloadRequired", "str_to_indices", "synsets_from_indices",
    "prepare_imagenet_train", "prepare_imagenet_validation",
    "ImageNetBase", "ImageNetTrain", "ImageNetValidation",
    "ImageNetSR", "ImageNetSRTrain", "ImageNetSRValidation",
]

# Acquisition manifest — the reference's pinned sources and exact sizes
# (``imagenet.py:136-143`` train, ``:198-210`` val, ``:66-85`` metadata).
TRAIN_TAR = "ILSVRC2012_img_train.tar"
TRAIN_TAR_SIZE = 147_897_477_120
TRAIN_AT_HASH = "a306397ccf9c2ead27155983c254227c0fd938e2"
VAL_TAR = "ILSVRC2012_img_val.tar"
VAL_TAR_SIZE = 6_744_924_160
VAL_AT_HASH = "5d6d0df7ed81efd49ca99ea4737e0ae5e3a5f2e5"
VAL_SYNSET_FILE = "validation_synset.txt"
VAL_SYNSET_SIZE = 1_950_000
VAL_SYNSET_URL = "https://heibox.uni-heidelberg.de/f/3e0f6e9c624e45f2bd73/?dl=1"
SYNSET_HUMAN_FILE = "synset_human.txt"
SYNSET_HUMAN_SIZE = 2_655_750
SYNSET_HUMAN_URL = "https://heibox.uni-heidelberg.de/f/9f28e956cd304264bb82/?dl=1"
IDX_SYNSET_FILE = "index_synset.yaml"
IDX_SYNSET_URL = "https://heibox.uni-heidelberg.de/f/d835d5b6ceda4d3aa910/?dl=1"
HUMAN2INT_FILE = "imagenet1000_clsidx_to_labels.txt"
HUMAN2INT_URL = "https://heibox.uni-heidelberg.de/f/2362b797d5be43b883f6/?dl=1"

# One corrupt file the reference unconditionally drops (``imagenet.py:49-52``).
IGNORE_FILES = frozenset({"n06596364_9591.JPEG"})

_READY_MARKER = ".ready"


class DownloadRequired(RuntimeError):
    """A required ImageNet file is absent and this environment cannot fetch
    it (zero egress). Carries the acquisition instructions the reference
    encodes as download calls (``imagenet.py:68-85,168-172,240-246``)."""

    def __init__(self, path: str, size: Optional[int], how: str):
        self.path, self.size, self.how = path, size, how
        want = f" (expected size {size:,} bytes)" if size else ""
        super().__init__(
            f"missing {path}{want}; acquire it out-of-band and place it "
            f"there. Reference acquisition route: {how}")


def _check_file(path: str, size: Optional[int], how: str,
                strict_size: bool = True) -> str:
    if not os.path.exists(path) or (
            strict_size and size and os.path.getsize(path) != size):
        raise DownloadRequired(path, size, how)
    return path


def str_to_indices(spec: str) -> List[int]:
    """``"5-10,17,63"`` -> ``[5,6,...,10,17,63]`` — the ``sub_indices``
    grammar (taming's ``str_to_indices``, used at ``imagenet.py:53-57``)."""
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return sorted(set(out))


def _load_idx2syn(path: str) -> Dict[int, str]:
    import yaml

    with open(path) as f:
        return {int(k): v for k, v in yaml.safe_load(f).items()}


def synsets_from_indices(indices: Sequence[int], idx2syn_path: str) -> List[str]:
    idx2syn = _load_idx2syn(idx2syn_path)
    return [idx2syn[i] for i in indices]


def _write_filelist(datadir: str, txt_filelist: str) -> int:
    rels = sorted(
        os.path.relpath(p, start=datadir)
        for p in glob.glob(os.path.join(datadir, "**", "*.JPEG"),
                           recursive=True))
    with open(txt_filelist, "w") as f:
        f.write("\n".join(rels) + "\n")
    return len(rels)


def prepare_imagenet_train(root: str, strict_size: bool = True) -> str:
    """Idempotently prepare ``<root>`` from ``ILSVRC2012_img_train.tar``.

    The train tar contains one tar per synset; each is extracted into its
    own ``data/<synset>/`` directory (``imagenet.py:163-185``). Returns the
    filelist path. Raises :class:`DownloadRequired` if the tarball is absent
    (or, with ``strict_size``, the wrong size — the reference's
    re-download condition, ``imagenet.py:168-169``).
    """
    os.makedirs(root, exist_ok=True)
    datadir = os.path.join(root, "data")
    txt_filelist = os.path.join(root, "filelist.txt")
    if os.path.exists(os.path.join(root, _READY_MARKER)):
        return txt_filelist
    if not os.path.isdir(datadir):
        tar_path = _check_file(
            os.path.join(root, TRAIN_TAR), TRAIN_TAR_SIZE,
            f"academictorrents hash {TRAIN_AT_HASH} "
            "(http://www.image-net.org/challenges/LSVRC/2012/)",
            strict_size)
        os.makedirs(datadir, exist_ok=True)
        with tarfile.open(tar_path, "r:") as tar:
            tar.extractall(path=datadir, filter="data")
        for subtar in sorted(glob.glob(os.path.join(datadir, "*.tar"))):
            subdir = subtar[:-len(".tar")]
            os.makedirs(subdir, exist_ok=True)
            with tarfile.open(subtar, "r:") as tar:
                tar.extractall(path=subdir, filter="data")
    _write_filelist(datadir, txt_filelist)
    open(os.path.join(root, _READY_MARKER), "w").close()
    return txt_filelist


def prepare_imagenet_validation(root: str, strict_size: bool = True) -> str:
    """Idempotently prepare ``<root>`` from ``ILSVRC2012_img_val.tar``.

    The val tar is flat; files are reorganized into synset folders from the
    ``validation_synset.txt`` name->synset map (``imagenet.py:230-260``).
    """
    os.makedirs(root, exist_ok=True)
    datadir = os.path.join(root, "data")
    txt_filelist = os.path.join(root, "filelist.txt")
    if os.path.exists(os.path.join(root, _READY_MARKER)):
        return txt_filelist
    if not os.path.isdir(datadir):
        tar_path = _check_file(
            os.path.join(root, VAL_TAR), VAL_TAR_SIZE,
            f"academictorrents hash {VAL_AT_HASH} "
            "(http://www.image-net.org/challenges/LSVRC/2012/)",
            strict_size)
        os.makedirs(datadir, exist_ok=True)
        with tarfile.open(tar_path, "r:") as tar:
            tar.extractall(path=datadir, filter="data")
        vs_path = _check_file(os.path.join(root, VAL_SYNSET_FILE),
                              VAL_SYNSET_SIZE, VAL_SYNSET_URL, strict_size)
        with open(vs_path) as f:
            name2syn = dict(line.split() for line in f.read().splitlines())
        for syn in sorted(set(name2syn.values())):
            os.makedirs(os.path.join(datadir, syn), exist_ok=True)
        for name, syn in name2syn.items():
            src = os.path.join(datadir, name)
            if os.path.exists(src):
                shutil.move(src, os.path.join(datadir, syn))
    _write_filelist(datadir, txt_filelist)
    open(os.path.join(root, _READY_MARKER), "w").close()
    return txt_filelist


class ImageNetBase(Dataset):
    """Filelist dataset yielding image + class_label (+ synset metadata).

    The filelist format matches the reference's prepared layout
    (``imagenet.py:26-131``): one relative path per line, synset directory
    names encode the class. ``sub_indices`` ("5-10,17") restricts to the
    given 1000-class indices via ``index_synset.yaml``;
    ``keep_orig_class_label`` reports those canonical indices instead of
    the dense re-enumeration (``imagenet.py:104-109``). ``human_label``
    comes from ``<root>/synset_human.txt`` when present (the reference
    downloads it unconditionally, ``imagenet.py:66-72``; offline we fall
    back to the synset id so prepared-but-unlabeled roots stay usable).
    """

    _PREPARE = None  # subclasses bind their prepare_* function

    def __init__(self, data_root: str, filelist: Optional[str] = None,
                 size: Optional[int] = None, random_crop: bool = False,
                 sub_indices: Optional[str] = None,
                 keep_orig_class_label: bool = False,
                 process_images: bool = True, seed: int = 0):
        self.data_root = data_root
        # prepared roots keep images under <root>/data; flat roots (tests,
        # pre-arranged extractions) may point straight at the synset dirs
        sub = os.path.join(data_root, "data")
        self.datadir = sub if os.path.isdir(sub) else data_root
        if filelist is None:
            filelist = os.path.join(data_root, "filelist.txt")
            if not os.path.exists(filelist) and self._PREPARE is not None:
                filelist = type(self)._PREPARE(data_root)
                self.datadir = os.path.join(data_root, "data")
        with open(filelist) as f:
            self.relpaths = [p for p in f.read().splitlines()
                             if os.path.basename(p) not in IGNORE_FILES]
        if sub_indices:
            idx2syn_path = os.path.join(data_root, IDX_SYNSET_FILE)
            if not os.path.exists(idx2syn_path):
                raise DownloadRequired(idx2syn_path, None, IDX_SYNSET_URL)
            keep = set(synsets_from_indices(str_to_indices(sub_indices),
                                            idx2syn_path))
            self.relpaths = [p for p in self.relpaths
                             if p.split("/")[0] in keep]
        synsets = sorted({p.split("/")[0] for p in self.relpaths})
        if keep_orig_class_label:
            idx2syn_path = os.path.join(data_root, IDX_SYNSET_FILE)
            if not os.path.exists(idx2syn_path):
                raise DownloadRequired(idx2syn_path, None, IDX_SYNSET_URL)
            self.synset2idx = {v: k for k, v in
                               _load_idx2syn(idx2syn_path).items()}
        else:
            self.synset2idx = {s: i for i, s in enumerate(synsets)}
        human_path = os.path.join(data_root, SYNSET_HUMAN_FILE)
        self.human_dict: Dict[str, str] = {}
        if os.path.exists(human_path):
            with open(human_path) as f:
                self.human_dict = dict(
                    line.split(maxsplit=1) for line in f.read().splitlines()
                    if line.strip())
        # human description -> canonical 1000-class integer, when the map
        # file is present (``imagenet.py:81-91``; "<int>:<human label>" lines)
        human2int_path = os.path.join(data_root, HUMAN2INT_FILE)
        self.human2integer_dict: Dict[str, int] = {}
        if os.path.exists(human2int_path):
            with open(human2int_path) as f:
                for line in f.read().splitlines():
                    value, key = line.split(":", 1)
                    self.human2integer_dict[key] = int(value)
        self.size = size
        self.random_crop = random_crop
        self.process_images = process_images
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.relpaths)

    def __getitem__(self, i: int) -> Dict:
        rel = self.relpaths[i]
        path = os.path.join(self.datadir, rel)
        synset = rel.split("/")[0]
        example = {
            "relpath": rel,
            "file_path_": path,
            "synsets": synset,
            "class_label": np.int32(self.synset2idx.get(synset, -1)),
            "human_label": self.human_dict.get(synset, synset),
        }
        if not self.process_images:
            return example
        img = load_rgb(path)
        if self.random_crop:
            crop = min(img.shape[:2])
            y = self._rng.integers(0, img.shape[0] - crop + 1)
            x = self._rng.integers(0, img.shape[1] - crop + 1)
            img = img[y:y + crop, x:x + crop]
        else:
            img = center_crop_square(img)
        if self.size:
            img = resize(img, self.size)
        example["image"] = (img / 127.5 - 1.0).astype(np.float32)
        return example


class ImageNetTrain(ImageNetBase):
    _PREPARE = staticmethod(prepare_imagenet_train)

    def __init__(self, **kwargs):
        kwargs.setdefault("random_crop", True)
        super().__init__(**kwargs)


class ImageNetValidation(ImageNetBase):
    _PREPARE = staticmethod(prepare_imagenet_validation)

    def __init__(self, **kwargs):
        kwargs.setdefault("random_crop", False)
        super().__init__(**kwargs)


class _Subset(Dataset):
    """Index-selected view of a dataset (torch ``Subset`` analog, used by
    the SR splits to pick the pre-selected HR examples,
    ``imagenet.py:381-394``)."""

    def __init__(self, base: Dataset, indices: Sequence[int]):
        self.base, self.indices = base, list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict:
        return self.base[self.indices[i]]


class ImageNetSR(Dataset):
    """(image, LR_image) pairs for SR training. Ref: ``imagenet.py:272-394``:
    1. crop a side-fraction in [min_crop_f, max_crop_f] (center or random),
    2. resize crop to ``size``,
    3. degrade to LR with the configured degradation_fn.
    """

    def __init__(self, base: Dataset, size: int = 256,
                 degradation: str = "bsrgan_light", downscale_f: int = 4,
                 min_crop_f: float = 0.5, max_crop_f: float = 1.0,
                 random_crop: bool = True, seed: int = 0):
        assert (size / downscale_f).is_integer()
        self.base = base
        self.size = size
        self.LR_size = int(size / downscale_f)
        self.downscale_f = downscale_f
        self.min_crop_f = min_crop_f
        self.max_crop_f = max_crop_f
        self.center_crop = not random_crop
        self._rng = np.random.default_rng(seed)

        if degradation == "bsrgan":
            self.degradation_process = partial(degradation_bsrgan, sf=downscale_f)
            self._pair = True
        elif degradation == "bsrgan_light":
            self.degradation_process = partial(degradation_bsrgan_variant, sf=downscale_f)
            self._pair = True
        elif degradation.startswith("cv_") or degradation.startswith("pil_"):
            # plain interpolation downsample variants (imagenet.py:311-333)
            self.degradation_process = None
            self._pair = False
        else:
            raise ValueError(degradation)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        example = self.base[i]
        if "image" in example:
            img = ((example["image"] + 1.0) * 127.5).astype(np.uint8)
        else:  # process_images=False base (the SR splits' convention)
            img = load_rgb(example["file_path_"])

        min_side = min(img.shape[:2])
        crop = int(min_side * self._rng.uniform(self.min_crop_f, self.max_crop_f))
        if self.center_crop:
            y = (img.shape[0] - crop) // 2
            x = (img.shape[1] - crop) // 2
        else:
            y = self._rng.integers(0, img.shape[0] - crop + 1)
            x = self._rng.integers(0, img.shape[1] - crop + 1)
        img = resize(img[y:y + crop, x:x + crop], self.size)

        hr01 = img.astype(np.float32) / 255.0
        if self._pair:
            lr01, _ = self.degradation_process(hr01, rng=self._rng)
        else:
            lr01 = resize(img, self.LR_size).astype(np.float32) / 255.0
        example["image"] = (hr01 * 2.0 - 1.0).astype(np.float32)
        example["LR_image"] = (lr01 * 2.0 - 1.0).astype(np.float32)
        return example


def _maybe_hr_subset(base: Dataset, hr_indices: Optional[str]) -> Dataset:
    """Apply the reference's pre-picked HR index pickle when provided
    (``data/imagenet_{train,val}_hr_indices.p``, ``imagenet.py:381-394``)."""
    if hr_indices is None:
        return base
    if not os.path.exists(hr_indices):
        raise DownloadRequired(
            hr_indices, None,
            "shipped with the reference repo as "
            "data/imagenet_{train,val}_hr_indices.p")
    with open(hr_indices, "rb") as f:
        return _Subset(base, pickle.load(f))


class ImageNetSRTrain(ImageNetSR):
    def __init__(self, data_root: str, filelist: Optional[str] = None,
                 hr_indices: Optional[str] = None, **kwargs):
        base = _maybe_hr_subset(
            ImageNetTrain(data_root=data_root, filelist=filelist,
                          process_images=False), hr_indices)
        super().__init__(base=base, random_crop=True, **kwargs)


class ImageNetSRValidation(ImageNetSR):
    def __init__(self, data_root: str, filelist: Optional[str] = None,
                 hr_indices: Optional[str] = None, **kwargs):
        base = _maybe_hr_subset(
            ImageNetValidation(data_root=data_root, filelist=filelist,
                               process_images=False), hr_indices)
        super().__init__(base=base, random_crop=False, **kwargs)
