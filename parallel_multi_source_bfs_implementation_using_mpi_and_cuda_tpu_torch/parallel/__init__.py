"""Query scheduling helpers (the NumPy half of the JAX package's
parallel/; the multi-device engines wait for a second card)."""
