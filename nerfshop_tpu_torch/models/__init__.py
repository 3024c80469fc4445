"""Encodings, MLPs and the NeRF network."""
