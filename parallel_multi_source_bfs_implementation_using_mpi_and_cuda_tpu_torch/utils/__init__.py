"""Host utilities: binary I/O, env knobs, timing counters, the report,
the fault plan, the checkpoint journal, the stats tables and telemetry."""
