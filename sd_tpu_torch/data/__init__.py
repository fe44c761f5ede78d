"""Data: the CLIP BPE and hash tokenizers, the bounding-box layout tokenizer,
the dict-of-arrays batch contract and its loader, and the synthetic
datasets (ports of ``sd_tpu/data``)."""
