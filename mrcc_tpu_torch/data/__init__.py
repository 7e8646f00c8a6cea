"""Synthetic scene data (numpy only)."""
