"""The benchmark's own tests: the harness and its reference on the CPU at
small sizes (``cuda``-marked tests need the card and skip here).

    python -m pytest benchmark/tests
    OMP_NUM_THREADS=2 python -m pytest benchmark/tests -n 3   # in parallel

The force-field cells keep their full widths and take minutes each on
the CPU; workers that each take every core slow one another down many
times over.

They import the harness as ``benchmark/run.py`` does, with
``benchmark/`` and the checkout's root on the path.
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
