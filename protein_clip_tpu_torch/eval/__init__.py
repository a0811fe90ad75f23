"""Retrieval over embeddings."""
