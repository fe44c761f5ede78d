"""Configs, random init and sd_tpu parameter conversion."""
