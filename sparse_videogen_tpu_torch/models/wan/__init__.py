"""Wan 2.1 DiT."""
