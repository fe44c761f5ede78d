"""Data: the CLIP BPE and hash tokenizers, the bounding-box layout tokenizer,
the dict-of-arrays batch contract and its loader, the synthetic datasets,
the LSUN and ImageNet(-SR) datasets with BSRGAN's degradation, and the
native C++ image loader (ports of ``sd_tpu/data``)."""
