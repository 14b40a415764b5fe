"""batch_build_ms of the proptrain cell (harness/program_spans.py)."""

from harness.program_spans import batch_build_ms as read  # noqa: F401
