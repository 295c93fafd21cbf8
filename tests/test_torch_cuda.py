"""Tests of the port that need the CUDA card (marked ``cuda``).

They skip where ``torch.cuda.is_available()`` is false.  This file imports
only the port, torch and numpy, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel uses float atomics, so it is held to the plain version at
rtol 1e-4 / atol 1e-6 (f32 summation order), never bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
from repro_torch.serve import IngestQueue, RankStore, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _packed(dev, be=512, vb=256, seed=11):
    edges, n = rmat_edges(10, 8, seed=seed)
    return spmv.pack_blocks(edges[:, 0], edges[:, 1],
                            np.ones(len(edges), bool), n, be=be, vb=vb,
                            spill_lanes_per_window=64, device=dev)


@pytest.mark.parametrize("frac", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, frac):
    packed = _packed(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    nw, vb = packed.num_windows, packed.vb
    rsc = torch.rand(nw * vb, generator=gen, device=cuda).to(dtype)
    awin = torch.rand(nw, generator=gen, device=cuda) < frac
    before = spmv.LAUNCH_COUNTS["frontier_spmv"]
    out = spmv.frontier_spmv_padded(packed, rsc, awin)
    torch.cuda.synchronize()
    assert spmv.LAUNCH_COUNTS["frontier_spmv"] == before + 1
    ref = frontier_spmv_ref_padded(packed.src, packed.dst_rel, packed.valid,
                                   packed.window, rsc, awin, vb)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
    assert bool((out[~awin.repeat_interleave(vb)] == 0).all())


def test_kernel_empty_graph_is_zero(cuda):
    none = np.zeros(0, np.int32)
    packed = spmv.pack_blocks(none, none, none.astype(bool), 1024, be=128,
                              vb=128, device=cuda)
    out = spmv.frontier_spmv_padded(
        packed, torch.ones(1024, device=cuda),
        torch.ones(packed.num_windows, dtype=torch.bool, device=cuda))
    assert float(out.abs().max()) == 0.0


def test_wrapper_checks_inputs(cuda):
    packed = _packed(cuda)
    v_pad = packed.num_windows * packed.vb
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="rsc must be float32 or bfloat16"):
        spmv.frontier_spmv_padded(packed, torch.ones(
            v_pad, dtype=torch.float64, device=cuda), awin)
    with pytest.raises(ValueError, match="active_window"):
        spmv.frontier_spmv_padded(packed, torch.ones(v_pad, device=cuda),
                                  awin[:-1])
    with pytest.raises(ValueError, match="is on cpu"):
        spmv.frontier_spmv_padded(packed.to("cpu"),
                                  torch.ones(v_pad, device=cuda), awin)


def test_serve_engine_kernel_matches_xla_on_card(cuda):
    edges, n = rmat_edges(12, 8, seed=5)
    snaps, launches = {}, {}
    for name in ("kernel", "xla"):
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
        ingest = IngestQueue(flush_size=128, flush_interval=1e9,
                             device=cuda)
        store = RankStore()
        eng = ServeEngine(graph, ingest, store, engine=name)
        eng.bootstrap()
        before = spmv.LAUNCH_COUNTS["frontier_spmv"]
        for b in range(3):
            dele, ins = random_batch_update(edges, n, 128, seed=b)
            for u, v in dele:
                ingest.submit_delete(int(u), int(v))
            for u, v in ins:
                ingest.submit_insert(int(u), int(v))
            assert eng.step(force=True)
        launches[name] = spmv.LAUNCH_COUNTS["frontier_spmv"] - before
        snaps[name] = store.snapshot().ranks
    assert launches["kernel"] > 0 and launches["xla"] == 0
    assert float((snaps["kernel"] - snaps["xla"]).abs().max()) <= 1e-6
