"""Kernel build/loading, the native host runtime (loader.cpp) and the
resilient-execution supervisor."""
