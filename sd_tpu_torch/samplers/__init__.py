"""Classifier-free guidance and the PLMS, DDIM and DPM-Solver++ samplers."""
