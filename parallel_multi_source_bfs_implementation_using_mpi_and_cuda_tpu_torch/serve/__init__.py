"""The serving runtime's engine registry, cut to what the CLI calls."""
