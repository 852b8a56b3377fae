"""Cosmos-1.0-Diffusion Text2World: the DiT and the CV8x8x8 tokenizer."""
