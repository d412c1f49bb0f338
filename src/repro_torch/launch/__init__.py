"""Meshes and rank processes for serving on several ranks."""
