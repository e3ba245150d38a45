"""Engines, the shared bit-plane level loop, and the kernel wrappers."""
