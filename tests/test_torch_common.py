"""Shared helpers for the PyTorch-port parity tests, plus the port's
device-resolution contract.

Both packages get the same seeded NumPy inputs; JAX objects are handed to
the port through ``repro_torch.convert`` as NumPy arrays.  Everything runs
on the CPU here: the port's entry points are called with ``device="cpu"``.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
from repro_torch import convert

CPU = "cpu"

# The suite runs in several pytest-xdist workers on the host's cores, and
# torch's default of one intra-op thread per core then oversubscribes the
# CPU: small ops wait in thread barriers, and the serve-driver tests ran
# ten times slower under load than alone.  These inputs are small; one
# thread per worker is enough.
torch.set_num_threads(1)

# The kernel engine tunes its pack geometry at bootstrap and caches the
# pick on disk; no test writes under the home directory: a test that tunes
# on purpose points the cache at its tmp_path, and any other lands in this
# worker's temporary directory.
os.environ.setdefault("REPRO_TORCH_TUNE_CACHE", os.path.join(
    tempfile.mkdtemp(prefix="repro_torch_tune_"), "kernel_tune.json"))


def np_(x):
    """NumPy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_graph(g):
    return convert.edge_list_from_numpy(
        np_(g.src), np_(g.dst), np_(g.valid), g.num_vertices,
        int(g.num_edges), device=CPU)


def port_update(u):
    return convert.batch_update_from_numpy(*(np_(x) for x in u), device=CPU)


def port_packed(p):
    return convert.packed_from_numpy(
        np_(p.src), np_(p.dst_rel), np_(p.valid), np_(p.window),
        np_(p.entry_start), np_(p.sorted_key), np_(p.sorted_lane),
        np_(p.ovl_key), np_(p.ovl_lane), num_vertices=p.num_vertices,
        vb=p.vb, be=p.be, max_entries_per_window=p.max_entries_per_window,
        device=CPU)


def assert_bitwise(a, b, what=""):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def chunked_sum(dst, terms, n, k):
    """The chunked order in NumPy: the terms of each vertex (``dst``, in
    slot order) cut into chunks of at most ``k``, each summed into its own
    row by ``np.add.at`` (in slot order, from +0.0), then a vertex's rows
    added to its first in chunk order."""
    counts = np.bincount(dst, minlength=n)
    order = np.argsort(dst, kind="stable")
    pos = np.empty(len(dst), np.int64)          # index within its vertex
    pos[order] = (np.arange(len(dst))
                  - (np.cumsum(counts) - counts)[dst[order]])
    per = np.maximum((counts + k - 1) // k, 1)  # chunks a vertex
    first = np.cumsum(per) - per
    rows = np.zeros(int(per.sum()))
    np.add.at(rows, first[dst] + pos // k, terms)
    out = rows[first].copy()
    for j in range(1, int(per.max())):
        more = per > j
        out[more] = out[more] + rows[first[more] + j]
    return out


def assert_graph_equal(port, ref, what=""):
    for name in ("src", "dst", "valid", "num_edges"):
        assert_bitwise(getattr(port, name), getattr(ref, name),
                       f"{what} {name}")
    assert port.num_vertices == ref.num_vertices


def assert_packed_equal(port, ref, what=""):
    """Every leaf bitwise, every static field equal."""
    for f in dataclasses.fields(ref):
        x, y = getattr(port, f.name), getattr(ref, f.name)
        if hasattr(y, "shape"):
            assert_bitwise(x, y, f"{what} {f.name}")
        else:
            assert x == y, (what, f.name, x, y)


# ---------------------------------------------------------------------------
# entry points never fall back to the CPU on their own
# ---------------------------------------------------------------------------

def _entry_points():
    from repro_torch.graph.dynamic import make_batch_update
    from repro_torch.graph.structure import from_coo
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import pack_blocks
    from repro_torch.ft.checkpoint import restore
    from repro_torch.launch.pagerank import main as pagerank_main
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.data.lm import Prefetcher, batches
    from repro_torch.models.transformer import init_cache
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.serve import IngestQueue
    e = np.asarray([[0, 1], [1, 2]], np.int32)
    return {
        "from_coo": lambda: from_coo(e[:, 0], e[:, 1], 4),
        "make_batch_update": lambda: make_batch_update(e, e, 4, 4),
        "pack_blocks": lambda: pack_blocks(e[:, 0], e[:, 1],
                                           np.ones(2, bool), 4, be=8, vb=4),
        "IngestQueue": lambda: IngestQueue(flush_size=4),
        "edge_list_from_numpy": lambda: convert.edge_list_from_numpy(
            e[:, 0], e[:, 1], np.ones(2, bool), 4, 2),
        "ranks_from_numpy": lambda: convert.ranks_from_numpy(np.ones(4)),
        "walk_index_from_numpy": lambda: convert.walk_index_from_numpy(
            np.zeros((4, 1, 2)), np.zeros(5), np.zeros(2), np.zeros(4),
            (0, 0), 1, 2, 0.85),
        "launch.serve": lambda: serve_main(["--events", "10"]),
        "launch.pagerank": lambda: pagerank_main(["--batches", "1"]),
        "checkpoint.restore": lambda: restore("no_such_dir", 0, {}),
        "launch.train": lambda: train_main(["--smoke", "--steps", "1"]),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(None),
        "Prefetcher": lambda: Prefetcher(batches(8, 1, 4)),
        "init_cache": lambda: init_cache(
            REGISTRY["qwen2.5-3b"].smoke_config, 1, 4),
        "sage_params_from_numpy": lambda: convert.sage_params_from_numpy(
            [dict(w_self=(np.ones((2, 2)), np.zeros(2)),
                  w_neigh=(np.ones((2, 2)), np.zeros(2)))]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_explicit_cpu_device_is_honoured():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    g = convert.edge_list_from_numpy(np.zeros(2), np.ones(2),
                                     np.ones(2, bool), 2, 2, device=CPU)
    assert g.src.device.type == "cpu" and g.src.dtype == torch.int32
