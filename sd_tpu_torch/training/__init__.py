"""Training: the diffusion loss and train step, AdamW with the LR multiplier
schedules, the EMA shadow, and the step-driven trainer (ports of
``sd_tpu/training``)."""
