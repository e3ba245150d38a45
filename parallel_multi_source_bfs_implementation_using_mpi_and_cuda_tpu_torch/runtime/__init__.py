"""Kernel build/loading and the resilient-execution supervisor."""
