"""K2: the fused GEGLU feed-forward, ``y = (a · gelu(g)) W2ᵀ + b2``.

Replaces the TPU kernel ``_kernel`` of ``sd_tpu/ops/pallas/geglu_ff.py``
(through ``_geglu_ff``, entry ``geglu_ff``). The CUDA kernels are in
``sd_tpu_torch/csrc/geglu_ff.cu``; its header says what bounds them on the
H100 and why the TPU kernel's single pass became two launches there.

Weights are in torch ``Linear`` layout: ``w1`` is ``[2·inner, C]`` with the
value rows first and the gate rows second (the reference's
``chunk(2, dim=-1)`` order), ``w2`` is ``[C_out, inner]``.

``geglu_ff`` launches the kernels for a CUDA tensor and uses
:func:`geglu_ff_plain` for a CPU tensor only. A CUDA tensor that is not
bf16, or a shape the kernels do not take, raises. ``geglu_ff.launches``
counts calls that launched (one per call, whatever the internal launches).

:func:`differentiable_geglu_ff` is the entry point for code that may need
gradients: where autograd records, a ``torch.autograd.Function`` runs K2
forward and, backward, recomputes through :func:`geglu_ff_plain` and takes
its vector-Jacobian product, as ``sd_tpu``'s ``_geglu_ff_bwd`` does through
``_split_reference`` (the JAX package has no backward kernel here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["geglu_ff", "geglu_ff_plain", "differentiable_geglu_ff"]


def geglu_ff_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products, exact-erf GELU in
    fp32, h rounded to the input dtype before the output projection."""
    inner = w2.shape[1]
    with torch.autocast(x.device.type, enabled=False):
        s = F.linear(x.float(), w1.float(), b1.float())
        a, g = s[..., :inner], s[..., inner:]
        h = (a * F.gelu(g)).to(x.dtype)
        return F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)


def _check_inputs(x, w1, b1, w2, b2):
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"geglu_ff: {name} is {t.dtype}; the card's path is "
                            f"bfloat16")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"geglu_ff: {name} is on {t.device}, x on {x.device}")
    c = x.shape[-1]
    c_out, inner = w2.shape
    if w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(
            f"geglu_ff: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} "
            f"do not match")
    if c % 8 or inner % 8:
        raise ValueError(f"geglu_ff: C={c} and inner={inner} must be multiples of 8")
    if x.numel() == 0:
        raise ValueError("geglu_ff: empty input")


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward over ``x [..., C]``; returns ``[..., C_out]``."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: no path for device {x.device}")
    _check_inputs(x, w1, b1, w2, b2)
    c = x.shape[-1]
    c_out, inner = w2.shape
    x2 = x.reshape(-1, c).contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    m = x2.shape[0]
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((m, c_out), dtype=x.dtype, device=x.device)
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"geglu_ff: {name} is not 16-byte aligned")
    lib = kernels()
    with torch.cuda.device(x.device):
        err = lib.sdt_geglu_ff(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), h.data_ptr(), y.data_ptr(), m, c, inner, c_out,
            stream_of(x))
    check(err, "geglu_ff")
    geglu_ff.launches += 1
    return y.view(*x.shape[:-1], c_out)


geglu_ff.launches = 0


class _GegluFF(torch.autograd.Function):
    """K2 forward; backward by recomputing the plain version (no kernel)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu_ff(x, w1, b1, w2, b2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(geglu_ff_plain(*inputs), wanted, dy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def differentiable_geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`geglu_ff` with a gradient: through the autograd function where
    autograd records, else the inference wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _GegluFF.apply(x, w1, b1, w2, b2)
    return geglu_ff(x, w1, b1, w2, b2)
