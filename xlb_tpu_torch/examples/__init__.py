"""Torch counterparts of the repository's example scripts."""
