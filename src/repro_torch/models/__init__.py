"""Dense transformer model code of the port (prefill path)."""
