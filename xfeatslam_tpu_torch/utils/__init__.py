"""Host-side utilities: synthetic RGB-D sequences."""
