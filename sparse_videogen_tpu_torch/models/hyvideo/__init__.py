"""HunyuanVideo (HYVideo-T/2) DiT."""
