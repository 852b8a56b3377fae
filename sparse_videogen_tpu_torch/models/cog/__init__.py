"""CogVideoX 1.5 DiT."""
