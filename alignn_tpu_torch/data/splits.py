"""Deterministic train/val/test index splits.

Counterpart of ``alignn_tpu/data/splits.py``, with the reference's
semantics: the standard library's ``random.shuffle`` seeded with
`split_seed`, ratios turned into counts with ``int()``, the val slice
taken from the tail just before the test slice, and `keep_data_order`
skipping the shuffle.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple


def get_id_train_val_test(
    total_size: int = 1000,
    split_seed: int = 123,
    train_ratio: Optional[float] = None,
    val_ratio: Optional[float] = 0.1,
    test_ratio: Optional[float] = 0.1,
    n_train: Optional[int] = None,
    n_test: Optional[int] = None,
    n_val: Optional[int] = None,
    keep_data_order: bool = False,
) -> Tuple[List[int], List[int], List[int]]:
    """(train, val, test) index lists over ``range(total_size)``."""
    if train_ratio is None and val_ratio is not None and \
            test_ratio is not None:
        if val_ratio + test_ratio >= 1:
            raise ValueError(f"val_ratio + test_ratio = "
                             f"{val_ratio + test_ratio} leaves no training set")
        train_ratio = 1 - val_ratio - test_ratio
    if n_train is None:
        n_train = int(train_ratio * total_size)
    if n_test is None:
        n_test = int(test_ratio * total_size)
    if n_val is None:
        n_val = int(val_ratio * total_size)
    ids = list(range(total_size))
    if not keep_data_order:
        random.seed(split_seed)
        random.shuffle(ids)
    if n_train + n_val + n_test > total_size:
        raise ValueError("Check total number of samples.",
                         n_train + n_val + n_test, ">", total_size)
    id_train = ids[:n_train]
    id_val = ids[-(n_val + n_test):-n_test] if n_test > 0 \
        else ids[-(n_val + n_test):]
    id_test = ids[-n_test:] if n_test > 0 else []
    return id_train, id_val, id_test
