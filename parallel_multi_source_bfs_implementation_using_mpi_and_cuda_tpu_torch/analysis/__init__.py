"""The port's static analysis: the JAX package's four AST passes —
trace-safety lint (on torch's trace and capture entries), lock
discipline, knob contract, error contract — and the dynamic lock-order
watchdog, over the files the port owns.  Entry point: ``python -m
<port> analyze`` (analysis.cli.analyze_main).  This package imports
neither torch nor the engine stack, so that it stays cheap.
"""

from .core import Finding  # noqa: F401
