"""Parameter conversion into the port's modules."""
