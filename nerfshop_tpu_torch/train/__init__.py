"""Losses, optimizer, the NeRF training step and distillation."""
