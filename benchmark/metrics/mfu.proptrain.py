"""mfu of the proptrain cell (harness/readers.py)."""

from harness.readers import mfu as read  # noqa: F401
