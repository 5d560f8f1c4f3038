"""Accelerator-memory pin lifecycle and the CUDA exporter."""
