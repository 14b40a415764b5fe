"""step_prep_idle_ms of the proptrain cell (harness/program_spans.py)."""

from harness.program_spans import step_prep_idle_ms as read  # noqa: F401
