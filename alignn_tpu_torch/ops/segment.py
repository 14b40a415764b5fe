"""Plain segment reductions for message passing.

Counterpart of ``alignn_tpu/ops/segment.py``: ``index_add`` scatter sums
over flat index arrays.  These are also the plain versions that the CUDA
kernels of :mod:`alignn_tpu_torch.ops.eggc` are held against.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum `data` rows into `num_segments` buckets (differentiable)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def graph_readout_mean(node_feats: torch.Tensor, node_graph: torch.Tensor,
                       n_nodes: torch.Tensor) -> torch.Tensor:
    """Per-graph mean over nodes, [N, F] -> [G, F], dividing by the real
    node counts (padded nodes sum into the trash graph slot)."""
    total = segment_sum(node_feats, node_graph, n_nodes.shape[0])
    return total / torch.clamp_min(n_nodes, 1.0)[:, None]


def edge_gated_aggregate(gated_src_feats: torch.Tensor, sigma: torch.Tensor,
                         dst: torch.Tensor, num_nodes: int,
                         eps: float = 1e-6) -> torch.Tensor:
    """h_i = (sum_{e: dst(e)=i} sigma_e * Bh_e) / (sum sigma_e + eps)."""
    f = gated_src_feats.shape[-1]
    packed = torch.cat([gated_src_feats * sigma, sigma], dim=-1)
    summed = segment_sum(packed, dst, num_nodes)
    return summed[:, :f] / (summed[:, f:] + eps)
