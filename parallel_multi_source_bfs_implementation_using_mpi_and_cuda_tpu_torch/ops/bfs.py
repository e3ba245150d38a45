"""Level-loop guards shared by the chunked engines."""

from __future__ import annotations


def validate_level_chunk(level_chunk):
    """A non-positive bound would make every chunk a no-op while
    ``updated`` stays true, so the host driver would loop forever: fail
    loud at construction instead.  ``None`` disables the bound."""
    if level_chunk is not None and level_chunk <= 0:
        raise ValueError(
            f"level_chunk must be positive (got {level_chunk}); "
            "use None to disable the bound"
        )
    return level_chunk
