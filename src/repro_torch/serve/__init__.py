"""repro_torch.serve — online rank serving on the DF/DF-P engines (twin of
``repro.serve``): an event queue that coalesces edge events into
capacity-padded micro-batches (``ingest``), a double-buffered snapshot
store (``state``), the update loop (``engine``), point and top-k queries
(``query``) and per-batch counters (``metrics``).
"""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.ingest import CoalescedBatch, EdgeEvent, IngestQueue, \
    coalesce_events
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.query import QueryClient, QueryResult
from repro_torch.serve.replay import preload_graph_and_feed
from repro_torch.serve.state import RankStore, Snapshot

__all__ = [
    "CoalescedBatch", "EdgeEvent", "IngestQueue", "QueryClient",
    "QueryResult", "RankStore", "ServeEngine", "ServeMetrics", "Snapshot",
    "coalesce_events", "preload_graph_and_feed",
]
