"""The first stages, NCHW (port of ``sd_tpu/models/vae.py``).

``Encoder`` and ``Decoder`` (with the mid-block and per-level attention of
``attn_type`` ``vanilla``, ``linear`` or ``none``, and resampling with or
without convs), ``AutoencoderKL`` (``encode`` → a :class:`DiagonalGaussian`,
``decode``, and the training forward: encode, a posterior sample or its
mode, decode; ``get_last_layer`` is the decoder's last conv weight, where
the VAE-GAN loss takes its adaptive weight), the VQ model
(:class:`VectorQuantizer`, :class:`VQModel`; also the reference's
``VQModelInterface``) and ``IdentityFirstStage`` for pixel-space diffusion.
Names follow the CompVis ``state_dict`` (``encoder.down.{i}.block.{j}``,
``encoder.mid.attn_1``, ``quant_conv``, ``quantize.embedding``,
``decoder.mid.block_1``, ``decoder.up.{i}.block.{j}``,
``decoder.up.{i}.upsample.conv``, ``post_quant_conv`` ...), which is what
``sd_tpu.models.vae.port_autoencoder_kl`` and ``port_vq_model`` read.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.ops.attention import LinearAttention, VAEAttnBlock
from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.norms import GroupNorm32
from sd_tpu_torch.ops.resblock import Upsample, VAEDownsample, VAEResnetBlock

__all__ = ["Encoder", "Decoder", "AutoencoderKL", "VectorQuantizer", "VQModel",
           "IdentityFirstStage"]


def _attn_type(attn_type: str, use_linear_attn: bool) -> str:
    """The reference's rule: ``use_linear_attn`` forces ``linear``."""
    attn_type = "linear" if use_linear_attn else attn_type
    if attn_type not in ("vanilla", "linear", "none"):
        raise ValueError(f"attn_type {attn_type!r}: expected vanilla, linear or none")
    return attn_type


def _make_attn(channels: int, attn_type: str) -> nn.Module:
    if attn_type == "vanilla":
        return VAEAttnBlock(channels)
    if attn_type == "linear":
        return LinearAttention(channels, heads=1, dim_head=channels)
    return nn.Identity()


class Encoder(nn.Module):
    """Conv ResNet encoder: images ``[B, 3, H, W]`` → moments
    ``[B, 2·z, H/f, W/f]`` (``z`` without ``double_z``)."""

    def __init__(self, *, ch: int, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 resolution: int = 256, z_channels: int = 4, attn_type: str = "vanilla",
                 use_linear_attn: bool = False, in_channels: int = 3, double_z: bool = True):
        # out_ch configures the decoder, which shares the ddconfig
        super().__init__()
        attn_type = _attn_type(attn_type, use_linear_attn)
        num_res = len(ch_mult)
        curr_res = resolution
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv3x3(in_channels, ch)
        self.down = nn.ModuleList()
        for i_level in range(num_res):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(VAEResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(_make_attn(block_in, attn_type))
            if i_level != num_res - 1:
                level.downsample = VAEDownsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = VAEResnetBlock(block_in, dropout=dropout)
        self.mid.attn_1 = _make_attn(block_in, attn_type)
        self.mid.block_2 = VAEResnetBlock(block_in, dropout=dropout)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv3x3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != len(self.down) - 1:
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """Conv ResNet decoder: latents ``[B, z, h, w]`` → images ``[B, 3, H, W]``."""

    def __init__(self, *, ch: int, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 resolution: int = 256, z_channels: int = 4, attn_type: str = "vanilla",
                 use_linear_attn: bool = False, in_channels: int = 3, double_z: bool = True):
        # in_channels and double_z configure the encoder, which shares the ddconfig
        super().__init__()
        attn_type = _attn_type(attn_type, use_linear_attn)
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = Conv3x3(z_channels, block_in)
        self.mid = nn.Module()
        self.mid.block_1 = VAEResnetBlock(block_in, dropout=dropout)
        self.mid.attn_1 = _make_attn(block_in, attn_type)
        self.mid.block_2 = VAEResnetBlock(block_in, dropout=dropout)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for i_block in range(num_res_blocks + 1):
                level.block.append(VAEResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(_make_attn(block_in, attn_type))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv3x3(block_in, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != 0:
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """KL-VAE first stage: ``encoder`` then ``quant_conv`` to the posterior's
    moments; ``post_quant_conv`` then ``decoder`` back to images."""

    def __init__(self, ddconfig: Dict[str, Any], embed_dim: int):
        super().__init__()
        if not ddconfig.get("double_z", True):
            raise ValueError("AutoencoderKL requires double_z")
        self.encoder = Encoder(**ddconfig)
        self.decoder = Decoder(**ddconfig)
        self.quant_conv = nn.Conv2d(2 * ddconfig["z_channels"], 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, ddconfig["z_channels"], 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """Images ``[B, 3, H, W]`` in [-1, 1] → the latent posterior, in the
        parameters' dtype."""
        x = x.to(self.quant_conv.weight.dtype)
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, embed_dim, h, w]`` → images in the parameters' dtype."""
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, sample_posterior: bool = True
                ) -> Tuple[torch.Tensor, DiagonalGaussian]:
        """``(reconstruction, posterior)``: the posterior sampled with
        ``noise`` (or a draw from ``generator``) where ``sample_posterior``,
        else its mode."""
        posterior = self.encode(x)
        z = (posterior.sample(generator, noise) if sample_posterior else posterior.mode())
        return self.decode(z), posterior

    def get_last_layer(self) -> torch.Tensor:
        return self.decoder.conv_out.weight


@contextlib.contextmanager
def _fp32_products(device: torch.device):
    """Matrix products in full fp32 within the block: autocast off for the
    device and TF32 off for cuBLAS."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class VectorQuantizer(nn.Module):
    """The codebook (``embedding``, ``[n_embed, embed_dim]``): each latent
    vector of ``[B, C, H, W]`` goes to its nearest code by squared distance
    (|z|² + |e|² − 2 z·e, computed in fp32 without TF32, as ``sd_tpu``
    computes it, so that a latent near the midpoint of two codes picks the
    same one in bf16), with the commitment loss ``beta ‖sg(z_q) − z‖² +
    ‖z_q − sg(z)‖²`` and straight-through gradients (taming's
    ``VectorQuantizer2`` without remapping)."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """The nearest code's index of every latent vector, ``[B, H, W]``."""
        b, c, h, w = z.shape
        with _fp32_products(z.device):
            flat = z.permute(0, 2, 3, 1).reshape(-1, c).float()
            codes = self.embedding.weight.float()
            d = (flat.square().sum(1, keepdim=True) + codes.square().sum(1)[None, :]
                 - 2.0 * flat @ codes.t())
        return d.argmin(dim=1).reshape(b, h, w)

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """Codes ``[B, H, W]`` → latents ``[B, embed_dim, H, W]``."""
        return self.embedding(idx).permute(0, 3, 1, 2)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(z_q, loss, indices)``, the loss in fp32; ``z_q`` in the dtype of
        ``z``: the codes themselves where autograd does not record, else
        ``z + sg(z_q − z)`` (equal up to rounding, which bf16 makes coarse)."""
        idx = self.indices(z)
        z_q = self.lookup(idx).to(z.dtype)
        z32, q32 = z.float(), z_q.float()
        loss = (self.beta * (q32.detach() - z32).square().mean()
                + (q32 - z32.detach()).square().mean())
        if torch.is_grad_enabled() and (z.requires_grad or z_q.requires_grad):
            z_q = z + (z_q - z).detach()
        return z_q, loss, idx


class VQModel(nn.Module):
    """The VQ first stage (the reference's ``VQModel`` and
    ``VQModelInterface``): ``encoder`` and ``quant_conv`` to the continuous
    latent (:meth:`encode_pre_quant`, ``VQModelInterface.encode``), the
    codebook ``quantize``, then ``post_quant_conv`` and ``decoder``.
    :meth:`decode` quantizes unless ``force_not_quantize``, as the
    reference's ``VQModelInterface.decode``."""

    def __init__(self, ddconfig: Dict[str, Any], n_embed: int, embed_dim: int,
                 beta: float = 0.25):
        super().__init__()
        self.encoder = Encoder(**ddconfig)
        self.decoder = Decoder(**ddconfig)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta)
        self.quant_conv = nn.Conv2d(ddconfig["z_channels"], embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, ddconfig["z_channels"], 1)

    def encode_pre_quant(self, x: torch.Tensor) -> torch.Tensor:
        """Images ``[B, 3, H, W]`` in [-1, 1] → the latent before
        quantization, in the parameters' dtype."""
        return self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(z_q, loss, indices)`` of the images' latent."""
        return self.quantize(self.encode_pre_quant(x))

    def quantize_latent(self, z: torch.Tensor):
        """A continuous latent through the codebook: ``(z_q, loss, indices)``."""
        return self.quantize(z)

    def decode(self, z: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        """Latents ``[B, embed_dim, h, w]`` → images in the parameters' dtype,
        through the codebook first unless ``force_not_quantize``."""
        z = z.to(self.post_quant_conv.weight.dtype)
        if not force_not_quantize:
            z = self.quantize(z)[0]
        return self.decoder(self.post_quant_conv(z))

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        """Code indices ``[B, h, w]`` → images."""
        return self.decode(self.quantize.lookup(code), force_not_quantize=True)

    def get_last_layer(self) -> torch.Tensor:
        return self.decoder.conv_out.weight

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(reconstruction, codebook loss, indices)``."""
        quant, diff, idx = self.encode(x)
        return self.decode(quant, force_not_quantize=True), diff, idx


class IdentityFirstStage(nn.Module):
    """The first stage of pixel-space diffusion: encode and decode are the
    identity."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
