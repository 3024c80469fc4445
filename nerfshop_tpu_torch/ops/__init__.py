"""Elementwise ops, march, compositing, grid and the hash-grid kernels."""
