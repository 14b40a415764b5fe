"""Radial basis expansion, smooth cutoff envelope and bond angles.

Counterpart of ``alignn_tpu/ops/basis.py`` (pure tensor functions).
"""

from __future__ import annotations

import numpy as np
import torch


def rbf_params(vmin: float, vmax: float, bins: int,
               lengthscale: float | None = None):
    """(centers, gamma) for the Gaussian RBF expansion.

    Keeps the reference's quirk: with the default lengthscale (the center
    spacing), gamma = 1/lengthscale, not 1/lengthscale**2.
    """
    centers = np.linspace(vmin, vmax, bins)
    if lengthscale is None:
        lengthscale = float(np.diff(centers).mean())
        gamma = 1.0 / lengthscale
    else:
        gamma = 1.0 / (lengthscale**2)
    return centers, float(gamma)


def rbf_expand(x: torch.Tensor, centers: torch.Tensor,
               gamma: float) -> torch.Tensor:
    """exp(-gamma * (x - centers)^2); [E] -> [E, bins]."""
    return torch.exp(-gamma * (x[..., None] - centers) ** 2)


def cutoff_function_based_edges(r: torch.Tensor, inner_cutoff: float = 4.0,
                                exponent: int = 3) -> torch.Tensor:
    """C^2 polynomial envelope inside the cutoff, zero outside."""
    ratio = r / inner_cutoff
    c1 = -(exponent + 1) * (exponent + 2) / 2
    c2 = exponent * (exponent + 2)
    c3 = -exponent * (exponent + 1) / 2
    envelope = (1 + c1 * ratio**exponent + c2 * ratio ** (exponent + 1)
                + c3 * ratio ** (exponent + 2))
    return torch.where(r <= inner_cutoff, envelope, torch.zeros_like(r))


def bond_cosines(r: torch.Tensor, lg_src: torch.Tensor,
                 lg_dst: torch.Tensor) -> torch.Tensor:
    """cos(theta) of each L-edge from the bond vectors, clipped to [-1, 1].

    r1 = -r[lg_src], r2 = r[lg_dst].  A backtracking L-edge (a bond paired
    with its own reverse) sits exactly at cos = 1; the clip is written as
    maximum/minimum so that its gradient there is 0.5, as ``jnp.clip``
    gives (``torch.clamp`` passes 1.0).
    """
    r1 = -r[lg_src]
    r2 = r[lg_dst]
    num = torch.sum(r1 * r2, dim=1)
    den = torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r2, dim=1)
    return _clip_cos(num / den)


def bond_cosines_dense(r: torch.Tensor, D: int) -> torch.Tensor:
    """cos(theta) of every local pair of the dense layout (graph/dense.py).

    The L-edge at pair (j, t, s) joins a = j*D+s and b = rev[j*D+t] with
    r_b == -r[j*D+t], so -r_a . r_b / (|r_a||r_b|) becomes the node-local
    r_s . r_t / (|r_s||r_t|): no gather.  Flat [N*D*D] in (j, t, s) order,
    s fastest.  The diagonal s = t (a bond and its own reverse) sits at
    cos = 1, on the clip bound.  Trash slots have r = (1, 0, 0), so no
    norm is zero.
    """
    n = r.shape[0] // D
    rb = r.reshape(n, D, 3)
    dots = torch.einsum("jtd,jsd->jts", rb, rb)
    norms = torch.linalg.norm(rb, dim=-1)
    den = norms[:, :, None] * norms[:, None, :]
    return _clip_cos(dots / den).reshape(-1)


def _clip_cos(cos: torch.Tensor) -> torch.Tensor:
    """clip to [-1, 1] as maximum/minimum, whose gradient at the bound is
    0.5 as ``jnp.clip`` gives (``torch.clamp`` passes 1.0)."""
    return torch.minimum(torch.maximum(cos, cos.new_tensor(-1.0)),
                         cos.new_tensor(1.0))
