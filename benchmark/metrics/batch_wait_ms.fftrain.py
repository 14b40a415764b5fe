"""batch_wait_ms of the fftrain cell (harness/readers.py)."""

from harness.readers import batch_wait_ms as read  # noqa: F401
