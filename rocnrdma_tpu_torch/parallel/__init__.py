"""Training of the port (the single-card train step)."""
