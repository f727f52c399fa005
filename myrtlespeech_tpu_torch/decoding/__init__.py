"""Decoders and error rates."""
