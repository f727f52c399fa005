"""Configuration schema of the port (a copy of the JAX package's)."""
