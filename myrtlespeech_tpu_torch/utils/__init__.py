"""Small host-side utilities (trace parsing)."""
