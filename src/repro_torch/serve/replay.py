"""Temporal-dataset → serving-feed preparation (twin of
``repro.serve.replay``, paper §5.1.4 split).

The first 90% of the timestamp-ordered edges build G⁰, the next
``num_events`` edges become the insert-event feed, and the edge capacity
is sized so the whole feed fits.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graph.structure import EdgeListGraph, from_coo

PRELOAD_FRAC = 0.9
CAPACITY_SLACK = 64


def preload_graph_and_feed(ds, num_events: int, device: DeviceLike = None
                           ) -> tuple[EdgeListGraph, np.ndarray]:
    """(G⁰ from the 90% preload, int32[(num_events,2)] event feed)."""
    pre_end = int(PRELOAD_FRAC * len(ds.edges))
    feed = ds.edges[pre_end: pre_end + num_events]
    pre = ds.edges[:pre_end]
    graph = from_coo(pre[:, 0], pre[:, 1], ds.num_vertices,
                     edge_capacity=len(pre) + len(feed) + CAPACITY_SLACK,
                     device=device)
    return graph, feed
