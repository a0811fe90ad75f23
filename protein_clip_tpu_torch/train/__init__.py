"""Checkpoints."""
