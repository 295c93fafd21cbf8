"""The plain reference on hand-worked cases, and beside the program on
small random ones (the program is imported here only to be compared)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts portbench/ and src/ on the path)
from reference import graph as ref_graph
from reference import pagerank as ref_pagerank
from reference import ppr as ref_ppr
from reference import threefry as ref_threefry
from reference import walks as ref_walks


def _graph(edges, capacity, n):
    src = torch.zeros(capacity, dtype=torch.int32)
    dst = torch.zeros(capacity, dtype=torch.int32)
    valid = torch.zeros(capacity, dtype=torch.bool)
    for i, (u, v) in enumerate(edges):
        src[i], dst[i], valid[i] = u, v, True
    return ref_graph.RefGraph(src, dst, valid, n)


def test_pagerank_hand_worked():
    # 0 -> 1 with the implicit loops: r0 = 0.075 / 0.575, r1 = 1 - r0
    g = _graph([(0, 1)], 2, 2)
    r = ref_pagerank.pagerank(g.src, g.dst, g.valid, 2)
    assert r.tolist() == pytest.approx([0.075 / 0.575, 1 - 0.075 / 0.575],
                                       abs=1e-15)
    r32 = ref_pagerank.pagerank(g.src, g.dst, g.valid, 2,
                                dtype=torch.float32)
    assert r32.dtype == torch.float32
    assert float((r32.double() - r).abs().max()) < 1e-6


def test_edge_list_bookkeeping_hand_worked():
    g = _graph([(0, 1), (0, 2), (1, 2)], 6, 3)
    # del (0,2) then ins (0,2): an insert of a live edge, so nothing;
    # (2,0) takes the first free slot; (1,2) is live; (2,1) ends deleted
    # and is absent
    ev = [(0, 0, 2), (1, 2, 0), (1, 1, 2), (1, 2, 1), (0, 2, 1), (1, 0, 2)]
    k, u, v = map(np.array, zip(*ev))
    g.apply(k, u, v)
    assert g.valid.tolist() == [True, True, True, True, False, False]
    assert list(zip(g.src[:4].tolist(), g.dst[:4].tolist())) == \
        [(0, 1), (0, 2), (1, 2), (2, 0)]
    # (0,1) frees slot 0, which the first (1,0) takes; the repeat is skipped
    g.apply(np.array([0, 1, 1]), np.array([0, 1, 1]), np.array([1, 0, 0]))
    assert list(zip(g.src[:4].tolist(), g.dst[:4].tolist())) == \
        [(1, 0), (0, 2), (1, 2), (2, 0)]
    assert g.num_live() == 4
    indptr, indices, deg = g.csr()
    assert deg.tolist() == [1, 2, 1]
    assert indices[indptr[1]:indptr[2]].tolist() == [0, 2]


def test_edge_list_matches_the_program_slot_for_slot():
    from repro_torch.graph.structure import EdgeListGraph
    from repro_torch.graph.dynamic import apply_batch
    from repro_torch.serve.ingest import IngestQueue
    rng = np.random.default_rng(3)
    n, cap = 40, 400
    e = np.unique(rng.integers(0, n, (150, 2)), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    ref = _graph(e.tolist(), cap, n)
    prog = EdgeListGraph(ref.src.clone(), ref.dst.clone(),
                         ref.valid.clone(), n)
    q = IngestQueue(flush_size=64, device="cpu")
    for _ in range(6):
        ev = rng.integers(0, n, (64, 2))
        kinds = rng.integers(0, 2, 64)
        for kind, (a, b) in zip(kinds, ev):
            if a != b:
                (q.submit_insert if kind else q.submit_delete)(int(a), int(b))
        keep = ev[:, 0] != ev[:, 1]
        ref.apply(kinds[keep], ev[keep, 0], ev[keep, 1])
        prog = apply_batch(prog, q.poll(force=True).update)
        assert torch.equal(prog.valid, ref.valid)
        assert torch.equal(prog.src[ref.valid], ref.src[ref.valid])
        assert torch.equal(prog.dst[ref.valid], ref.dst[ref.valid])


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
])
def test_threefry_known_answers(key, ctr, want):
    # Random123's known-answer vectors for threefry2x32, 20 rounds
    y = ref_threefry.threefry2x32(key[0], key[1], ctr[0], ctr[1])
    assert (int(y[0]), int(y[1])) == want


def test_walks_and_estimates_match_the_program():
    from repro_torch.graph.structure import EdgeListGraph
    from repro_torch.ppr import IndexConfig, build_walk_index, ppr_top_k
    rng = np.random.default_rng(5)
    n = 64
    e = np.unique(rng.integers(0, n, (500, 2)), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    ref = _graph(e.tolist(), 600, n)
    prog = EdgeListGraph(ref.src.clone(), ref.dst.clone(),
                         ref.valid.clone(), n)
    seed = 2**33 + 17
    index = build_walk_index(prog, IndexConfig(num_walks=8, max_len=7,
                                               seed=seed))
    indptr, indices, deg = ref.csr()
    w = ref_walks.walks(indptr, indices, deg, torch.arange(n), 8, 7, 0.85,
                        seed)
    assert torch.equal(w, index.steps)
    for s in (0, 5, 31):
        est = ref_ppr.estimate(indptr, indices, deg, s, num_walks=8,
                               max_len=7, alpha=0.85, key_seed=seed)
        idx, vals = ppr_top_k(index, [s], 10)
        assert torch.allclose(est[idx], vals, rtol=1e-12, atol=0)
        assert float(torch.topk(est, 10).values[-1]) <= float(vals[-1]) \
            + 1e-15
