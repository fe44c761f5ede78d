"""UNet, KL decoder, CLIP text tower and LatentDiffusion."""
