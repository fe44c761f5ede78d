"""Invisible watermark: embed and decode (copies of ``embed_watermark_batch``,
``embed_watermark`` and ``decode_watermark`` and their helpers from
``sd_tpu/utils/watermark.py``).

DWT+DCT quantization-index modulation, as the reference's ``dwtDct``: a
1-level Haar DWT of the luma channel, 4x4 DCT blocks of the LL subband, one
payload bit per block embedded by quantizing a mid-frequency coefficient;
:func:`decode_watermark` reads each block's bit back and takes the
majority over the blocks that carry each payload bit. Host-side numpy on
uint8 images; each 4x4 DCT is the fixed orthonormal map ``D @ blk @ D.T``,
so the batch embeds as einsums. Needs ``cv2`` for the RGB/YUV conversion,
imported at call time.
"""

from __future__ import annotations

import numpy as np

__all__ = ["embed_watermark", "embed_watermark_batch", "decode_watermark",
           "WATERMARK_PAYLOAD"]

WATERMARK_PAYLOAD = b"StableDiffusionV1"
_Q = 12.0          # quantization step
_COEFF = (2, 2)    # embedded DCT coefficient
_BLOCK = 4


def _dct_mat(n: int = _BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix (matches cv2.dct on an n x n block)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    d = np.cos(np.pi * (2.0 * x + 1.0) * k / (2.0 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return d.astype(np.float32)


_D = _dct_mat()


def _haar_dwt2(x):
    """[..., H, W] -> LL and (H, V, D) subbands at half resolution."""
    a = (x[..., 0::2, 0::2] + x[..., 1::2, 0::2]
         + x[..., 0::2, 1::2] + x[..., 1::2, 1::2]) / 4.0
    h = (x[..., 0::2, 0::2] + x[..., 1::2, 0::2]
         - x[..., 0::2, 1::2] - x[..., 1::2, 1::2]) / 4.0
    v = (x[..., 0::2, 0::2] - x[..., 1::2, 0::2]
         + x[..., 0::2, 1::2] - x[..., 1::2, 1::2]) / 4.0
    d = (x[..., 0::2, 0::2] - x[..., 1::2, 0::2]
         - x[..., 0::2, 1::2] + x[..., 1::2, 1::2]) / 4.0
    return a, (h, v, d)


def _haar_idwt2(a, hvd):
    h, v, d = hvd
    H, W = a.shape[-2:]
    out = np.zeros(a.shape[:-2] + (H * 2, W * 2), a.dtype)
    out[..., 0::2, 0::2] = a + h + v + d
    out[..., 1::2, 0::2] = a + h - v - d
    out[..., 0::2, 1::2] = a - h + v - d
    out[..., 1::2, 1::2] = a - h - v + d
    return out


def _bits(payload: bytes):
    return np.unpackbits(np.frombuffer(payload, np.uint8))


def _to_blocks(ll):
    """[B, H, W] -> [B, bh, bw, 4, 4] block view (copy)."""
    b, h, w = ll.shape
    bh, bw = h // _BLOCK, w // _BLOCK
    return (ll.reshape(b, bh, _BLOCK, bw, _BLOCK)
            .transpose(0, 1, 3, 2, 4).copy(), bh, bw)


def _from_blocks(blk, bh, bw):
    b = blk.shape[0]
    return blk.transpose(0, 1, 3, 2, 4).reshape(b, bh * _BLOCK, bw * _BLOCK)


def _rgb_yuv(imgs):
    """Batch RGB→YUV (BT.601, cv2 conventions)."""
    import cv2

    return np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2YUV) for im in imgs])


def _yuv_rgb(yuvs):
    import cv2

    return np.stack([cv2.cvtColor(yv, cv2.COLOR_YUV2RGB) for yv in yuvs])


def embed_watermark_batch(imgs: np.ndarray,
                          payload: bytes = WATERMARK_PAYLOAD) -> np.ndarray:
    """uint8 RGB [B, H, W, 3] -> watermarked uint8 RGB (same shape).

    H and W must be multiples of 8 (true for all SD output sizes).
    """
    bits = _bits(payload)
    yuv = _rgb_yuv(imgs).astype(np.float32)
    y = yuv[..., 0]                                      # [B, H, W]
    ll, hvd = _haar_dwt2(y)
    blk, bh, bw = _to_blocks(ll)                         # [B,bh,bw,4,4]

    d = np.einsum("ij,...jk,lk->...il", _D, blk, _D)     # D @ blk @ D.T
    c = d[..., _COEFF[0], _COEFF[1]]                     # [B, bh, bw]
    pattern = bits[np.arange(bh * bw) % len(bits)].reshape(bh, bw)
    q = np.round(c / _Q)
    mismatch = (q.astype(np.int64) & 1) != pattern       # broadcast over B
    adj = np.where(c / _Q - q >= 0, 1.0, -1.0)
    q = np.where(mismatch, q + adj, q)
    d[..., _COEFF[0], _COEFF[1]] = q * _Q
    blk = np.einsum("ji,...jk,kl->...il", _D, d, _D)     # D.T @ d @ D

    ll = _from_blocks(blk, bh, bw)
    yuv[..., 0] = np.clip(_haar_idwt2(ll, hvd), 0, 255)
    return _yuv_rgb(yuv.astype(np.uint8))


def embed_watermark(img: np.ndarray, payload: bytes = WATERMARK_PAYLOAD) -> np.ndarray:
    """One uint8 RGB image [H, W, 3] through :func:`embed_watermark_batch`."""
    return embed_watermark_batch(img[None], payload)[0]


def decode_watermark(img: np.ndarray, n_bytes: int = len(WATERMARK_PAYLOAD)) -> bytes:
    """The ``n_bytes`` payload of a uint8 RGB image [H, W, 3]: each block's
    bit is the parity of its quantized coefficient, and each payload bit the
    majority over the blocks that carry it."""
    n_bits = n_bytes * 8
    ll, _ = _haar_dwt2(_rgb_yuv(img[None]).astype(np.float32)[..., 0])
    blk, bh, bw = _to_blocks(ll)
    d = np.einsum("ij,...jk,lk->...il", _D, blk, _D)
    bit = np.round(d[0, ..., _COEFF[0], _COEFF[1]] / _Q).astype(np.int64) & 1  # [bh, bw]
    votes = np.zeros((n_bits, 2), np.int64)
    np.add.at(votes, (np.arange(bh * bw) % n_bits, bit.reshape(-1)), 1)
    return np.packbits((votes[:, 1] > votes[:, 0]).astype(np.uint8)).tobytes()
