"""Hand-written CUDA kernels for Hopper (the counterpart of ``sd_tpu.ops.pallas``).

Each module holds a kernel wrapper, the plain PyTorch version of the same
function, and a launch counter on the wrapper. The sources are in
``sd_tpu_torch/csrc`` and are built at first use (``_build.py``).
"""

from sd_tpu_torch.ops.cuda.flash_attention import (
    differentiable_flash_attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from sd_tpu_torch.ops.cuda.geglu_ff import differentiable_geglu_ff, geglu_ff, geglu_ff_plain

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain", "differentiable_flash_attention",
           "geglu_ff", "geglu_ff_plain", "differentiable_geglu_ff"]
