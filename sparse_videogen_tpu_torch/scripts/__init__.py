"""Measurement scripts of the torch port, run as `python -m`."""
