"""sd_tpu_torch — the PyTorch and CUDA port of sd_tpu for NVIDIA Hopper (H100).

The JAX package ``sd_tpu`` is the reference: each module here mirrors the
module of the same path there and is tested against it on the CPU. The Pallas
TPU kernels on the ported path are hand-written CUDA kernels for ``sm_90a``
(``csrc/``, wrapped in ``ops/cuda/``), built with ``nvcc`` at first use.

Subpackages
-----------
core       schedule tables and the timestep embedding
ops        norms, convs, resblocks, attention; ``ops/cuda`` holds the kernels
models     UNet, KL decoder, CLIP text tower, LatentDiffusion
samplers   classifier-free guidance and PLMS
pipelines  txt2img and build_txt2img_pipeline
utils      configs, random init, sd_tpu parameter conversion
scripts    the txt2img CLI (``python -m sd_tpu_torch.scripts.txt2img``)
"""
