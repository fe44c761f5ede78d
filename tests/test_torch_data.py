"""The port's datasets, degradation and native loader against sd_tpu's on
the CPU: the LSUN, ImageNet and ImageNet-SR items of one synthetic tree
(seeded JPEGs in synset folders, a filelist, an HR-index pickle, an LSUN
txt_file) from the same seeds, every degradation function from the same
``np.random.Generator`` seed, MATLAB's ``imresize``, PSNR and SSIM, the
ImageNet preparation from synthetic tarballs (and ``DownloadRequired`` where
one is missing), the registry's dataset targets, and the C++ loader on the
same files.

Tolerance: none. Every comparison is exact (``assert_array_equal``, ``==``):
both packages run the same numpy, PIL and OpenCV calls on the same inputs
and draws.
"""

import os
import pickle
import shutil
import tarfile

import numpy as np
import pytest
from PIL import Image

from sd_tpu.data import degradation as jdeg
from sd_tpu.data import imagenet as jimagenet
from sd_tpu.data import lsun as jlsun
from sd_tpu_torch.data import degradation as deg
from sd_tpu_torch.data import imagenet, lsun
from sd_tpu_torch.utils import config

SYNSETS = ["n01000001", "n01000002", "n01000003"]


def _jpeg(path, seed, hw):
    arr = (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path, format="JPEG", quality=90)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A flat ImageNet-style root (synset folders, filelist.txt, the
    metadata files), an HR-index pickle, and an LSUN txt_file over the same
    images; the images are landscape and portrait, so crops matter."""
    root = tmp_path_factory.mktemp("imagenet")
    rels = []
    for s, syn in enumerate(SYNSETS):
        (root / syn).mkdir()
        for i in range(2):
            rel = f"{syn}/{syn}_{i}.JPEG"
            _jpeg(root / rel, 10 * s + i, (72, 96) if i else (88, 64))
            rels.append(rel)
    (root / "filelist.txt").write_text("\n".join(rels) + "\n")
    (root / "synset_human.txt").write_text(
        "n01000001 tench, Tinca tinca\nn01000002 goldfish\nn01000003 shark\n")
    (root / "index_synset.yaml").write_text("".join(
        f"{7 + i}: {syn}\n" for i, syn in enumerate(SYNSETS)))
    hr = root / "hr_indices.p"
    with open(hr, "wb") as f:
        pickle.dump([1, 4, 5], f)
    txt = root / "lsun.txt"
    txt.write_text("\n".join(rels) + "\n")
    return {"root": str(root), "hr": str(hr), "txt": str(txt)}


def _equal_items(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def _check_dataset(ds, jds, passes: int = 2):
    assert len(ds) == len(jds)
    for _ in range(passes):  # a second pass: the datasets' own generators moved on
        for i in range(len(ds)):
            _equal_items(ds[i], jds[i])


@pytest.mark.parametrize("name", ["LSUNBedroomsTrain", "LSUNChurchesValidation"])
def test_lsun_items_are_sd_tpus(tree, name):
    kw = dict(txt_file=tree["txt"], data_root=tree["root"], size=40, seed=3)
    _check_dataset(getattr(lsun, name)(**kw), getattr(jlsun, name)(**kw))


@pytest.mark.parametrize("name,kw", [
    ("ImageNetTrain", {}),
    ("ImageNetValidation", {}),
    ("ImageNetTrain", {"sub_indices": "7,9", "keep_orig_class_label": True}),
    ("ImageNetValidation", {"process_images": False}),
], ids=["train", "validation", "sub_indices", "no_images"])
def test_imagenet_items_are_sd_tpus(tree, name, kw):
    kw = dict(data_root=tree["root"], size=48, seed=5, **kw)
    _check_dataset(getattr(imagenet, name)(**kw), getattr(jimagenet, name)(**kw))


@pytest.mark.parametrize("name,degradation,hr", [
    ("ImageNetSRTrain", "bsrgan_light", True),
    ("ImageNetSRTrain", "bsrgan", False),
    ("ImageNetSRValidation", "bsrgan_light", True),
    ("ImageNetSRValidation", "pil_nearest", False),
])
def test_imagenet_sr_pairs_are_sd_tpus(tree, name, degradation, hr):
    pytest.importorskip("cv2")
    kw = dict(data_root=tree["root"], size=64, degradation=degradation, downscale_f=4,
              seed=11, hr_indices=tree["hr"] if hr else None)
    ds = getattr(imagenet, name)(**kw)
    _check_dataset(ds, getattr(jimagenet, name)(**kw), passes=1)
    item = ds[0]
    assert item["image"].shape == (64, 64, 3) and item["LR_image"].shape == (16, 16, 3)
    assert len(ds) == (3 if hr else 6)


def _image01(seed, hw=(40, 48)):
    """A smooth image in [0, 1] with texture, float32 HWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / max(hw)
    base = np.stack([yy, xx, (yy + xx) / 2], -1)
    return np.clip(base + 0.1 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)


# each case: (name, call of a module's function on an image and a generator)
DEGRADATIONS = {
    "add_blur": lambda m, img, rng: m.add_blur(img, rng, sf=4),
    "add_blur_light": lambda m, img, rng: m.add_blur(img, rng, sf=4, light=True),
    "add_resize": lambda m, img, rng: m.add_resize(img, rng, sf=4),
    "add_gaussian_noise": lambda m, img, rng: m.add_gaussian_noise(img, rng),
    "add_poisson_noise": lambda m, img, rng: m.add_poisson_noise(img, rng),
    "add_speckle_noise": lambda m, img, rng: m.add_speckle_noise(img, rng),
    "add_jpeg_noise": lambda m, img, rng: m.add_jpeg_noise(img, rng),
    "degradation_bsrgan": lambda m, img, rng: m.degradation_bsrgan(img, sf=4, rng=rng),
    "degradation_bsrgan_variant": lambda m, img, rng: m.degradation_bsrgan_variant(
        img, sf=4, rng=rng),
}


@pytest.mark.parametrize("name", sorted(DEGRADATIONS))
def test_degradation_matches_sd_tpu(name):
    pytest.importorskip("cv2")
    fn = DEGRADATIONS[name]
    for seed in range(6):  # enough draws to take each branch of the noises
        img = _image01(seed, (64, 64))
        got = fn(deg, img.copy(), np.random.default_rng(seed))
        want = fn(jdeg, img.copy(), np.random.default_rng(seed))
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_gaussian_kernels_imresize_psnr_ssim_match_sd_tpu():
    pytest.importorskip("cv2")
    np.testing.assert_array_equal(deg.iso_gaussian_kernel(9, 1.7), jdeg.iso_gaussian_kernel(9, 1.7))
    np.testing.assert_array_equal(deg.aniso_gaussian_kernel(11, 2.0, 0.7, 0.4),
                                  jdeg.aniso_gaussian_kernel(11, 2.0, 0.7, 0.4))
    img = _image01(3)
    for scale in (0.25, 0.5, 1.5, 2.0):
        np.testing.assert_array_equal(deg.imresize(img, scale), jdeg.imresize(img, scale))
        np.testing.assert_array_equal(deg.imresize(img[..., 0], scale),
                                      jdeg.imresize(img[..., 0], scale))
    a, b = img * 255, _image01(4) * 255
    assert deg.psnr(a, b) == jdeg.psnr(a, b) and deg.psnr(a, b, border=2) == jdeg.psnr(
        a, b, border=2)
    assert deg.psnr(a, a) == float("inf")
    assert deg.ssim(a, b) == jdeg.ssim(a, b) and deg.ssim(a, a) == pytest.approx(1.0)


def _train_tar_root(path, synsets=SYNSETS[:2]):
    """A root holding a synthetic ILSVRC2012_img_train.tar (a tar per synset)."""
    stage = path / "stage"
    path.mkdir()
    subtars = []
    for s, syn in enumerate(synsets):
        (stage / syn).mkdir(parents=True)
        with tarfile.open(stage / f"{syn}.tar", "w") as tar:
            for i in range(2):
                name = f"{syn}_{i}.JPEG"
                _jpeg(stage / syn / name, 40 + 10 * s + i, (24, 32))
                tar.add(stage / syn / name, arcname=name)
        subtars.append(stage / f"{syn}.tar")
    root = path / "root"
    root.mkdir()
    with tarfile.open(root / imagenet.TRAIN_TAR, "w") as tar:
        for sub in subtars:
            tar.add(sub, arcname=sub.name)
    return root


def _val_tar_root(path):
    names = [f"ILSVRC2012_val_0000000{i}.JPEG" for i in range(1, 5)]
    path.mkdir()
    root = path / "root"
    root.mkdir()
    with tarfile.open(root / imagenet.VAL_TAR, "w") as tar:
        for i, name in enumerate(names):
            _jpeg(path / name, 80 + i, (20, 28))
            tar.add(path / name, arcname=name)
    (root / imagenet.VAL_SYNSET_FILE).write_text("".join(
        f"{name} {SYNSETS[i % 2]}\n" for i, name in enumerate(names)))
    return root


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if not f.endswith(".tar"))


@pytest.mark.parametrize("split", ["train", "validation"])
def test_prepare_matches_sd_tpu_and_never_fetches(tmp_path, split):
    make = _train_tar_root if split == "train" else _val_tar_root
    prep = {"train": "prepare_imagenet_train", "validation": "prepare_imagenet_validation"}[split]
    roots = [make(tmp_path / "port"), make(tmp_path / "sd_tpu")]
    got = getattr(imagenet, prep)(str(roots[0]), strict_size=False)
    want = getattr(jimagenet, prep)(str(roots[1]), strict_size=False)
    assert open(got).read() == open(want).read() and len(open(got).read().split()) == 4
    assert _listing(roots[0]) == _listing(roots[1])
    mtime = os.path.getmtime(got)
    assert getattr(imagenet, prep)(str(roots[0]), strict_size=False) == got  # idempotent
    assert os.path.getmtime(got) == mtime
    ds = (imagenet.ImageNetTrain if split == "train" else imagenet.ImageNetValidation)(
        data_root=str(roots[0]), size=16)
    assert ds[0]["image"].shape == (16, 16, 3) and ds[0]["synsets"] == SYNSETS[0]
    # a missing tarball (or a wrong size) raises with the reference's source
    with pytest.raises(imagenet.DownloadRequired, match="academictorrents"):
        getattr(imagenet, prep)(str(tmp_path / "empty"))
    with pytest.raises(imagenet.DownloadRequired, match="expected size"):
        getattr(imagenet, prep)(str(make(tmp_path / "sized")))
    if split == "validation":  # the synset map is required too
        root = _val_tar_root(tmp_path / "no_map")
        os.remove(root / imagenet.VAL_SYNSET_FILE)
        with pytest.raises(imagenet.DownloadRequired, match="heibox"):
            imagenet.prepare_imagenet_validation(str(root), strict_size=False)
    with pytest.raises(imagenet.DownloadRequired, match="hr_indices"):
        imagenet.ImageNetSRTrain(data_root=str(roots[0]), hr_indices=str(tmp_path / "x.p"))
    assert imagenet.str_to_indices("5-7, 2,5") == jimagenet.str_to_indices("5-7, 2,5")


def test_registry_builds_the_datasets(tree):
    for module, name in (("lsun", "LSUNBedroomsTrain"), ("lsun", "LSUNCatsValidation")):
        ds = config.instantiate_from_config({"target": f"ldm.data.{module}.{name}", "params": {
            "txt_file": tree["txt"], "data_root": tree["root"], "size": 16}})
        assert type(ds).__name__ == name and ds[0]["image"].shape == (16, 16, 3)
    for name in ("ImageNetTrain", "ImageNetValidation", "ImageNetSRTrain",
                 "ImageNetSRValidation"):
        for prefix in ("ldm.data.imagenet", "sd_tpu_torch.data.imagenet"):
            ds = config.instantiate_from_config({"target": f"{prefix}.{name}", "params": {
                "data_root": tree["root"], "size": 32}})
            assert isinstance(ds, getattr(imagenet, name)) and len(ds) == 6


def test_native_loader_matches_sd_tpu(tree):
    from sd_tpu.data import native_loader as jnative
    from sd_tpu_torch.data import native_loader

    if not native_loader.native_available():
        pytest.skip("native/dataloader.cpp does not build here (g++, libjpeg or libpng)")
    if not jnative.native_available():
        pytest.skip("sd_tpu's native loader does not build here")
    paths = [os.path.join(tree["root"], line) for line in
             open(tree["txt"]).read().split()] + ["/nonexistent.png"]
    loader, jloader = native_loader.NativeImageLoader(2), jnative.NativeImageLoader(2)
    for size, seed in ((48, -1), (32, 7), (100, 3)):
        got, ok = loader.load_batch(paths, size, flip_seed=seed)
        want, jok = jloader.load_batch(paths, size, flip_seed=seed)
        np.testing.assert_array_equal(got, want)
        assert ok.tolist() == jok.tolist() == [True] * 6 + [False]
    # at the crop's size, no resampling: the dataset's own decode and crop
    ds = lsun.LSUNBedroomsTrain(txt_file=tree["txt"], data_root=tree["root"], flip_p=0.0)
    got, _ = loader.load_batch(paths[:1], 64)
    np.testing.assert_allclose(got[0], ds[0]["image"], rtol=0, atol=1e-6)
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.load_batch(paths, 8)


def test_native_loader_raises_the_build_error(monkeypatch, tmp_path):
    from sd_tpu_torch.data import native_loader

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SOURCE", bad)
    monkeypatch.setattr(native_loader, "_BUILD_DIR", tmp_path / "build")
    native_loader.build_native_loader.cache_clear()
    native_loader._load_lib.cache_clear()
    try:
        if shutil.which("g++") is None:
            pytest.skip("no g++ here")
        with pytest.raises(RuntimeError, match="the build failed"):
            native_loader.NativeImageLoader()
        assert not native_loader.native_available()
    finally:
        native_loader.build_native_loader.cache_clear()
        native_loader._load_lib.cache_clear()
