"""Alphabet and datasets (numpy only)."""
