"""HunyuanVideo (HYVideo-T/2) DiT and its causal-3D VAE."""
