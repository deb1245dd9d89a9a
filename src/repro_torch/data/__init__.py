"""Synthetic datasets of the port (numpy, identical to the reference's)."""
