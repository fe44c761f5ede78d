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
    flash_attention_int8,
    flash_attention_int8_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
    resolve_int8,
)
from sd_tpu_torch.ops.cuda.fused_block import (
    block_weights,
    fused_block,
    fused_block_plain,
    tail_fused,
    tail_fused_plain,
)
from sd_tpu_torch.ops.cuda.fused_conv import fused_conv3x3, fused_conv3x3_plain
from sd_tpu_torch.ops.cuda.geglu_ff import (
    differentiable_geglu_ff,
    geglu_ff,
    geglu_ff_int8,
    geglu_ff_int8_plain,
    geglu_ff_plain,
)
from sd_tpu_torch.ops.cuda.int8_dense import int8_dense, int8_dense_plain
from sd_tpu_torch.ops.cuda.winograd_conv import (
    winograd_conv3x3,
    winograd_conv3x3_plain,
    winograd_conv3x3_split,
)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain", "differentiable_flash_attention",
           "flash_attention_int8", "flash_attention_int8_plain", "resolve_int8",
           "geglu_ff", "geglu_ff_plain", "differentiable_geglu_ff", "geglu_ff_int8",
           "geglu_ff_int8_plain", "int8_dense", "int8_dense_plain", "fused_conv3x3",
           "fused_conv3x3_plain", "winograd_conv3x3", "winograd_conv3x3_split",
           "winograd_conv3x3_plain", "fused_block", "fused_block_plain", "tail_fused",
           "tail_fused_plain", "block_weights", "COUNTED", "launch_counts"]

# the wrappers that count their launches (``<wrapper>.launches``)
COUNTED = ("flash_attention", "geglu_ff", "flash_attention_bwd", "geglu_ff_int8",
            "flash_attention_int8", "int8_dense", "fused_conv3x3", "winograd_conv3x3",
            "winograd_conv3x3_split", "fused_block", "tail_fused")


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process so far, by name."""
    return {name: globals()[name].launches for name in COUNTED}
