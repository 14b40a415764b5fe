"""The card's published peaks, the least time of a launch, and the bytes
and operations of the sparse segment kernels K1 and K2.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit (the result line carries the card's name; ``PERF.md`` its limit).
``bound`` is the arithmetic of the program's ``chip_smoke.py``, copied.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12     # HBM3
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12  # TF32 products on the tensor cores
H100_BF16_FLOP_PER_S = 989e12  # bf16 / f16 products on the tensor cores


def bound(nbytes: float, flops: float, products: float = 0.0,
          dtype: str = "float32"):
    """(least seconds, what bounds it): the larger of the bytes' time at
    the HBM rate and the operations' time, elementwise operations at the
    f32 rate and matrix products at the bf16 rate (16-bit operands) or as
    three TF32 products (an f32-grade product)."""
    if dtype in ("bfloat16", "float16"):
        t_products = products / H100_BF16_FLOP_PER_S
    else:
        t_products = 3.0 * products / H100_TF32_FLOP_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_F32_FLOP_PER_S + t_products
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def eggc_bytes_flops(kind: str, rows: int, segments: int, features: int,
                     itemsize: int):
    """(bytes, elementwise operations) of one launch.

    K1, gated aggregation: reads m and bh [rows, F] and the CSR pointer
    [segments + 1] (int32), writes out [segments, F]; per element a
    sigmoid (4), the gated and the gate sums (3), per output an add and a
    divide.  K2, sorted segment sum: reads x [rows, F] and the pointer,
    writes [segments, F]; one add per element.  Each input byte is counted
    once and each output byte once."""
    index = 4 * (segments + 1)
    out = segments * features * itemsize
    if kind == "K1":
        return (2 * rows * features * itemsize + index + out,
                7.0 * rows * features + 2.0 * segments * features)
    if kind == "K2":
        return rows * features * itemsize + index + out, \
            1.0 * rows * features
    raise ValueError(f"unknown kernel {kind}")


def eggc_least_seconds(kind, rows, segments, features, itemsize) -> float:
    nbytes, flops = eggc_bytes_flops(kind, rows, segments, features,
                                     itemsize)
    return bound(nbytes, flops)[0]
