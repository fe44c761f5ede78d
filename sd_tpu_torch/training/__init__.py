"""Training: the diffusion loss and train step, AdamW with the LR multiplier
schedules, the EMA shadow, the step-driven trainer, the first stages'
VAE-GAN and VQ-GAN, and the noisy-latent classifier (ports of
``sd_tpu/training``)."""
