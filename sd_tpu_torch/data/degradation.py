"""BSRGAN's degradation pipeline for super-resolution training, with
MATLAB's bicubic ``imresize``, PSNR and SSIM (a copy of
``sd_tpu/data/degradation.py``, which holds no JAX; the port keeps its own).

Randomized chains of blur (isotropic or anisotropic Gaussian), resampling,
Gaussian, Poisson and speckle noise and JPEG compression turn an HR crop
into its LR pair: :func:`degradation_bsrgan` (the full chain, in a shuffled
order) and :func:`degradation_bsrgan_variant` (``bsrgan_light``, which the
LDM super-resolution model trains on). Every draw comes from the
``np.random.Generator`` passed in, so a seed gives ``sd_tpu``'s pairs.
Host code (numpy and OpenCV); images are float32 HWC in [0, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "imresize", "psnr", "ssim",
    "iso_gaussian_kernel", "aniso_gaussian_kernel",
    "add_blur", "add_resize", "add_gaussian_noise", "add_poisson_noise",
    "add_speckle_noise", "add_jpeg_noise",
    "degradation_bsrgan", "degradation_bsrgan_variant",
]


# ------------------------------------------------------------ MATLAB imresize


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _resize_weights(in_len, out_len, scale):
    kernel_width = 4.0
    if scale < 1:  # antialias: widen kernel
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - idx - 1
    if scale < 1:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    # prune zero columns
    keep = ~np.all(w == 0, axis=0)
    return w[:, keep], idx[:, keep]


def imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB-equivalent bicubic resize with antialiasing (HWC float)."""
    img = np.asarray(img, np.float64)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    wh, ih = _resize_weights(h, oh, scale)
    out = np.einsum("oi,oiwc->owc", wh, img[ih])
    ww, iw = _resize_weights(w, ow, scale)
    out = np.einsum("oi,hoic->hoc", ww, out[:, iw])
    out = out.astype(np.float32)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------- metrics


def psnr(a: np.ndarray, b: np.ndarray, border: int = 0) -> float:
    """PSNR on [0,255] uint8-range images. Ref: ``utils_image.py:621``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if border:
        a = a[border:-border, border:-border]
        b = b[border:-border, border:-border]
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * np.log10(255.0 / np.sqrt(mse))


def _ssim_2d(a, b):
    import cv2

    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = kernel @ kernel.T
    mu1 = cv2.filter2D(a, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(b, -1, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = cv2.filter2D(a * a, -1, window)[5:-5, 5:-5] - mu1_sq
    s2 = cv2.filter2D(b * b, -1, window)[5:-5, 5:-5] - mu2_sq
    s12 = cv2.filter2D(a * b, -1, window)[5:-5, 5:-5] - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


def ssim(a: np.ndarray, b: np.ndarray, border: int = 0) -> float:
    """SSIM on [0,255] images. Ref: ``utils_image.py:642``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if border:
        a = a[border:-border, border:-border]
        b = b[border:-border, border:-border]
    if a.ndim == 2:
        return float(_ssim_2d(a, b))
    return float(np.mean([_ssim_2d(a[..., i], b[..., i]) for i in range(a.shape[2])]))


# ------------------------------------------------------------- blur kernels


def iso_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-(xx**2 + yy**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def aniso_gaussian_kernel(ksize: int, sigma_x: float, sigma_y: float,
                          theta: float) -> np.ndarray:
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    c, s = np.cos(theta), np.sin(theta)
    xr = c * xx + s * yy
    yr = -s * xx + c * yy
    k = np.exp(-(xr**2 / (2 * sigma_x**2) + yr**2 / (2 * sigma_y**2)))
    return (k / k.sum()).astype(np.float32)


# -------------------------------------------------------- degradation ops


def add_blur(img, rng: np.random.Generator, sf: int = 4, light: bool = False):
    import cv2

    wd = 2.0 + 0.2 * sf if not light else 0.4 + sf / 4.0
    ksize = 2 * rng.integers(2, 11) + 3
    if rng.random() < 0.5:
        theta = rng.uniform(0, np.pi)
        sx = wd * rng.uniform(0.3, 1.0) + 1e-3
        sy = wd * rng.uniform(0.3, 1.0) + 1e-3
        k = aniso_gaussian_kernel(int(ksize), sx, sy, theta)
    else:
        k = iso_gaussian_kernel(int(ksize), wd * rng.uniform(0.3, 1.0) + 1e-3)
    return cv2.filter2D(img, -1, k, borderType=cv2.BORDER_REFLECT)


def add_resize(img, rng: np.random.Generator, sf: int = 4):
    import cv2

    r = rng.random()
    if r > 0.8:
        scale = 1.0
    elif r > 0.6:
        scale = rng.uniform(0.5, 1.0)
    else:
        scale = rng.uniform(0.5 / sf, 1.0)
    interp = int(rng.choice([1, 2, 3]))
    h, w = img.shape[:2]
    img = cv2.resize(img, (max(int(scale * w), 1), max(int(scale * h), 1)),
                     interpolation=interp)
    return np.clip(img, 0.0, 1.0)


def add_gaussian_noise(img, rng: np.random.Generator, noise_level1: int = 2,
                       noise_level2: int = 25):
    level = rng.integers(noise_level1, noise_level2) / 255.0
    r = rng.random()
    if r > 0.6:  # per-channel
        img = img + rng.normal(0, level, img.shape).astype(np.float32)
    elif r > 0.4:  # grayscale
        img = img + rng.normal(0, level, img.shape[:2] + (1,)).astype(np.float32)
    else:  # correlated color noise
        L = level * 2
        d = np.diag(rng.random(3))
        u, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        conv = (u.T @ d @ u).astype(np.float32)
        noise = rng.multivariate_normal([0, 0, 0], np.abs(L**2 * conv),
                                        img.shape[:2]).astype(np.float32)
        img = img + noise
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img, rng: np.random.Generator):
    vals = 10 ** (2 * rng.random() + 2.0)
    img = np.clip(img, 0, 1)
    img = rng.poisson(img * vals).astype(np.float32) / vals
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img, rng: np.random.Generator, noise_level1: int = 2,
                      noise_level2: int = 25):
    level = rng.integers(noise_level1, noise_level2) / 255.0
    img = np.clip(img, 0, 1)
    img = img + img * rng.normal(0, level, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img, rng: np.random.Generator):
    import cv2

    quality = int(rng.integers(30, 96))
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    _, enc = cv2.imencode(".jpg", u8[:, :, ::-1],
                          [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, 1)[:, :, ::-1]
    return dec.astype(np.float32) / 255.0


# ----------------------------------------------------------- full pipelines


def _final_downsample(img, sf, rng, hr_shape):
    """Resize to exactly HR//sf regardless of intermediate random resizes —
    the reference's terminal resize (bsrgan.py:520-522)."""
    import cv2

    h, w = hr_shape[:2]
    return cv2.resize(img, (w // sf, h // sf),
                      interpolation=int(rng.choice([1, 2, 3])))


def degradation_bsrgan(img: np.ndarray, sf: int = 4,
                       rng: Optional[np.random.Generator] = None,
                       isp_prob: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Full randomized chain. Ref: ``bsrgan.py:438-527``.

    img: HWC float32 [0,1] (the HR crop). Returns (LR, HR)."""
    rng = rng or np.random.default_rng()
    hq = img.copy()
    order = rng.permutation(7)
    lq = img.copy()
    for step in order:
        if step in (0, 1):
            lq = add_blur(lq, rng, sf=sf)
        elif step == 2:
            lq = add_resize(lq, rng, sf=sf)
        elif step == 3:
            if rng.random() < 0.5:
                lq = add_gaussian_noise(lq, rng)
        elif step == 4:
            if rng.random() < 0.5:
                lq = add_poisson_noise(lq, rng)
        elif step == 5:
            if rng.random() < 0.1:
                lq = add_speckle_noise(lq, rng)
        elif step == 6:
            if rng.random() < 0.9:
                lq = add_jpeg_noise(lq, rng)
    lq = _final_downsample(lq, sf, rng, hq.shape)
    lq = add_jpeg_noise(lq, rng)  # final jpeg, always
    return lq.astype(np.float32), hq.astype(np.float32)


def degradation_bsrgan_variant(img: np.ndarray, sf: int = 4,
                               rng: Optional[np.random.Generator] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """The lighter variant used for LDM-SR training. Ref:
    ``bsrgan_light.py:534-616`` — milder blur, gentler noise, no speckle."""
    rng = rng or np.random.default_rng()
    hq = img.copy()
    lq = img.copy()
    if rng.random() < 0.5:
        lq = add_blur(lq, rng, sf=sf, light=True)
    lq = add_resize(lq, rng, sf=sf)
    if rng.random() < 0.5:
        lq = add_gaussian_noise(lq, rng, noise_level1=2, noise_level2=8)
    if rng.random() < 0.5:
        lq = add_jpeg_noise(lq, rng)
    lq = _final_downsample(lq, sf, rng, hq.shape)
    return lq.astype(np.float32), hq.astype(np.float32)
