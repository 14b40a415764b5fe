"""eggc_roofline of the fftrain cell (harness/readers.py)."""

from harness.readers import eggc_roofline as read  # noqa: F401
