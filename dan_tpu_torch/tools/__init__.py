"""Measurement tools for the port that run on a CUDA card (not imported by the package)."""
