"""Modules of the models (``nn.Module``s)."""
