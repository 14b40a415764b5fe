"""fp8 (e4m3) storage for the L(g)-sized activation tables.

Counterpart of ``alignn_tpu/ops/fp8.py``: a straight-through round trip
through ``torch.float8_e4m3fn`` (largest normal 448) with one f32 scale a
row, max|row| / 448.  The value is quantized, the gradient is the
identity (so a saved residual stays a differentiable function of the
inputs, and the grad-of-grad of the force loss flows through it).

Opt-in with ``ALIGNN_TPU_FP8_LTABLES`` (the JAX package's own switch:
unset, empty and "0" are off), read at each call as JAX reads it at each
trace.  Applied where JAX applies it: the residual m2 that the dense pair
aggregation (K4) saves for its backward (:mod:`alignn_tpu_torch.ops.dense`),
the dense L-stage's edge output and the sparse ``z`` at each
``ALIGNNConv`` boundary (:mod:`alignn_tpu_torch.nn.layers`).  In the port
the round trip is a value transform: the tables stay in the compute dtype
in device memory.
"""

from __future__ import annotations

import os

import torch

E4M3_MAX = 448.0


def fp8_ltables_enabled() -> bool:
    """The switch: unset, empty and "0" mean off."""
    return os.environ.get("ALIGNN_TPU_FP8_LTABLES", "") not in ("", "0")


def quantize_e4m3(x: torch.Tensor):
    """x -> (q in float8_e4m3fn, f32 scale [rows, 1]); q * scale ~= x row
    by row.  The scale is max(max|row|, 1e-30) / 448, computed in f32 as
    JAX computes it, and x / scale rounds to nearest even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / E4M3_MAX
    return (xf / scale).to(torch.float8_e4m3fn), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


class _RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        q, scale = quantize_e4m3(x)
        return dequantize(q, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """x through e4m3 and back, in x's dtype; the gradient passes
    unchanged (straight through), at every derivative order."""
    return _RoundTrip.apply(x)
