"""Device-mesh arithmetic (multi-GPU comes later)."""
