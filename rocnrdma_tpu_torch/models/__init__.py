"""Model family of the port (Llama)."""
