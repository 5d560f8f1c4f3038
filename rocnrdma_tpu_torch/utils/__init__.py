"""Utilities shared by the port's modules."""
