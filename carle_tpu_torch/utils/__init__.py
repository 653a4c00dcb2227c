"""Host-side writers of episode artifacts: PNG frames and animated GIFs."""
