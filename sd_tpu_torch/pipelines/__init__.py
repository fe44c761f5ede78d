"""The pipelines: txt2img with its safety checker and ``build_txt2img_pipeline``,
img2img and inpainting, super-resolution, and tiled application."""
