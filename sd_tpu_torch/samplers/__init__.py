"""Classifier-free guidance and the PLMS sampler."""
