"""Losses, optimizer and the NeRF training step."""
