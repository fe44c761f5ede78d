"""Classifier-free guidance and the PLMS, DDIM, DPM-Solver++ and ancestral
DDPM samplers."""

from sd_tpu_torch.samplers.ancestral import p_sample_loop, progressive_denoising
from sd_tpu_torch.samplers.ddim import ddim_decode, ddim_sample, ddim_stochastic_encode
from sd_tpu_torch.samplers.dpm_solver import dpm_solver_sample
from sd_tpu_torch.samplers.plms import plms_sample

__all__ = ["ddim_sample", "ddim_stochastic_encode", "ddim_decode", "plms_sample",
           "dpm_solver_sample", "p_sample_loop", "progressive_denoising"]
