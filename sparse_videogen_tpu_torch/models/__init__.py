"""Model families (Wan 2.1 T2V)."""
