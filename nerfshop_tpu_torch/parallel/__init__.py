"""Multi-GPU data-parallel training and pixel-sharded rendering (``mesh.py``)."""
