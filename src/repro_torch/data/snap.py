"""SNAP temporal-network loading with deterministic synthetic stand-ins.

The paper evaluates on five SNAP temporal graphs (Table 1).  This container
is offline, so for each named dataset we provide:
  * a real loader for the SNAP text format (``u v t`` per line) if a file is
    present under ``$REPRO_DATA`` or ``data/``;
  * otherwise a *scaled-down synthetic stand-in* generated with the same
    qualitative structure (localised temporal updates, power-law degrees)
    and the same |E_T|/|E| duplication ratio, so every benchmark in
    benchmarks/ runs end-to-end offline.

The port's copy of ``repro.data.snap``: the same names and seeds give the
same edge streams.
"""
from __future__ import annotations

import functools
import os
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.graph.generators import temporal_stream_edges

# name -> (|V|, |E_T|, |E|) from paper Table 1, and the synthetic scale we
# use on CPU (|V|_synth).  Ratios |E_T|/|V| and |E_T|/|E| are preserved.
PAPER_TABLE1 = {
    "sx-mathoverflow":      (24_818, 506_550, 239_978),
    "sx-askubuntu":         (159_316, 964_437, 596_933),
    "sx-superuser":         (194_085, 1_443_339, 924_886),
    "wiki-talk-temporal":   (1_140_149, 7_833_140, 3_309_592),
    "sx-stackoverflow":     (2_601_977, 63_497_050, 36_233_450),
}
_SYNTH_SCALE_V = {
    # sized so per-iteration edge work dominates XLA-CPU dispatch overhead
    "sx-mathoverflow": 12_000,
    "sx-askubuntu": 16_000,
    "sx-superuser": 20_000,
    "wiki-talk-temporal": 30_000,
    "sx-stackoverflow": 40_000,
}


@dataclass
class TemporalDataset:
    name: str
    edges: np.ndarray        # int32[(T,2)] timestamp-ordered (u, v)
    num_vertices: int
    synthetic: bool


def _find_file(name: str):
    for root in (os.environ.get("REPRO_DATA", ""), "data"):
        if not root:
            continue
        for ext in (".txt", ".csv", ""):
            p = os.path.join(root, name + ext)
            if os.path.exists(p):
                return p
    return None


@functools.lru_cache(maxsize=8)
def load_temporal(name: str, seed: int = 0) -> TemporalDataset:
    if name not in PAPER_TABLE1:
        raise KeyError(f"unknown dataset {name}; options {list(PAPER_TABLE1)}")
    path = _find_file(name)
    if path is not None:
        raw = np.loadtxt(path, dtype=np.int64, comments=("#", "%"))
        order = np.argsort(raw[:, 2], kind="stable")
        edges = raw[order, :2]
        ids = np.unique(edges)
        remap = {int(v): i for i, v in enumerate(ids)}
        edges = np.vectorize(lambda v: remap[int(v)])(edges)
        return TemporalDataset(name, edges.astype(np.int32), len(ids), False)

    v_full, et_full, _ = PAPER_TABLE1[name]
    n = _SYNTH_SCALE_V[name]
    m = max(1000, int(et_full / v_full * n))      # preserve |E_T|/|V|
    # process-stable name hash: builtin hash() is randomized per process,
    # which regenerated a DIFFERENT synthetic graph on restart and broke
    # checkpoint-resume (restored ranks belonged to another graph)
    name_h = zlib.crc32(name.encode()) % 1000
    edges = temporal_stream_edges(n, m, seed=seed + name_h)
    return TemporalDataset(name, edges, n, True)


def all_paper_datasets(seed: int = 0):
    return [load_temporal(name, seed) for name in PAPER_TABLE1]
