"""ESM-2 backbone, CLIP heads."""
