"""device_idle of the proptrain cell (harness/readers.py)."""

from harness.readers import device_idle as read  # noqa: F401
