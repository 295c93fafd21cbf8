"""NumPy arrays → the port's structures.

This system has no weights; its state is the graph, the packed structure,
the update batch and the ranks.  These functions build each of them from
plain NumPy arrays and ints (for example arrays read out of the JAX
package with ``np.asarray``), so two implementations can be handed the
same state.  Arrays are copied to ``device`` with their dtypes fixed to
the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.dynamic import BatchUpdate
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph


def _t(a, dtype, device) -> torch.Tensor:
    # a copy: the source may be a read-only view of another framework's
    # buffer, and the port owns its tensors
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def edge_list_from_numpy(src, dst, valid, num_vertices: int,
                         num_edges: int, device: DeviceLike = None
                         ) -> EdgeListGraph:
    device = resolve_device(device)
    return EdgeListGraph(
        src=_t(src, np.int32, device), dst=_t(dst, np.int32, device),
        valid=_t(valid, bool, device), num_vertices=int(num_vertices),
        num_edges=torch.tensor(int(num_edges), dtype=torch.int32,
                               device=device))


def packed_from_numpy(src, dst_rel, valid, window, entry_start, sorted_key,
                      sorted_lane, ovl_key, ovl_lane, *, num_vertices: int,
                      vb: int, be: int, max_entries_per_window: int,
                      device: DeviceLike = None) -> PackedGraph:
    """All nine leaves plus the static fields of a ``PackedGraph``."""
    device = resolve_device(device)
    return PackedGraph(
        src=_t(src, np.int32, device), dst_rel=_t(dst_rel, np.int32, device),
        valid=_t(valid, np.float32, device),
        window=_t(window, np.int32, device),
        entry_start=_t(entry_start, np.int32, device),
        sorted_key=_t(sorted_key, np.int64, device),
        sorted_lane=_t(sorted_lane, np.int32, device),
        ovl_key=_t(ovl_key, np.int64, device),
        ovl_lane=_t(ovl_lane, np.int32, device),
        num_vertices=int(num_vertices), vb=int(vb), be=int(be),
        max_entries_per_window=int(max_entries_per_window))


def batch_update_from_numpy(del_src, del_dst, del_mask, ins_src, ins_dst,
                            ins_mask, device: DeviceLike = None
                            ) -> BatchUpdate:
    device = resolve_device(device)
    return BatchUpdate(
        del_src=_t(del_src, np.int32, device),
        del_dst=_t(del_dst, np.int32, device),
        del_mask=_t(del_mask, bool, device),
        ins_src=_t(ins_src, np.int32, device),
        ins_dst=_t(ins_dst, np.int32, device),
        ins_mask=_t(ins_mask, bool, device))


def ranks_from_numpy(ranks, device: DeviceLike = None) -> torch.Tensor:
    """f64[V] ranks."""
    return _t(ranks, np.float64, resolve_device(device))
