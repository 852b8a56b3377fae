"""Layers and rotary embeddings shared by the DiTs."""
