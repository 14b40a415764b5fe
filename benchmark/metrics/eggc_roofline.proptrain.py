"""eggc_roofline of the proptrain cell (harness/readers.py)."""

from harness.readers import eggc_roofline as read  # noqa: F401
