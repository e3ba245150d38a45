"""Host utilities: binary I/O, env knobs, timing counters, the report."""
