"""Layers and rotary embeddings shared by the DiTs, and the text and image encoders."""
