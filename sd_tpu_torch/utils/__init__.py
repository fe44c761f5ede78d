"""Configs, checkpoint loading, random init, image files and sd_tpu
parameter conversion."""
