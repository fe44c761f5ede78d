"""UNet, KL autoencoder, CLIP text and vision towers and LatentDiffusion."""
