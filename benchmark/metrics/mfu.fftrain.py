"""mfu of the fftrain cell (harness/readers.py)."""

from harness.readers import mfu as read  # noqa: F401
