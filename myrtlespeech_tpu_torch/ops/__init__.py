"""Tensor ops: masking, features, recurrences."""
