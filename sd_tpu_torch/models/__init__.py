"""UNet, the classifier's half-UNet, the KL and VQ autoencoders, CLIP text
and vision towers, the cond-stage encoders and LatentDiffusion."""
