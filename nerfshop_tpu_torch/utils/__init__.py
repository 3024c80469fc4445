"""Host-side utilities: image quality metrics."""
