"""The txt2img pipeline, its safety checker and ``build_txt2img_pipeline``."""
