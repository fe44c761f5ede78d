"""The txt2img pipeline and ``build_txt2img_pipeline``."""
