"""Entry points: embed, serve."""
