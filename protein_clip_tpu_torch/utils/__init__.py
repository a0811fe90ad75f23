"""Seeding."""
