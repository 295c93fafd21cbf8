"""Port parity: window-range sharding of the packed graph
(``repro_torch.kernels.pagerank_spmv.shard``) against the reference's
mesh-free functions, bit for bit: the sharded pack, delta routing (and
its budget errors), the per-shard update over a stream, the halo and its
upkeep, the wire bytes; then the shard-local SpMV against the unsharded
one and the collectives against a NumPy transcription of the reference's
formula.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.dist.pagerank_dist import halo_comm_bytes as j_comm_bytes
from repro.graph.dynamic import make_batch_update as j_make_update
from repro.graph.generators import update_stream
from repro.graph.structure import from_coo as j_from_coo
from repro.kernels.pagerank_spmv import shard as jsh

from repro_torch.dist.collectives import MAX_WIRE_SHARDS, bool_or_psum, \
    int8_psum
from repro_torch.dist.pagerank_dist import halo_comm_bytes
from repro_torch.graph.dynamic import make_batch_update
from repro_torch.kernels.pagerank_spmv import shard as sh
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
from repro_torch.kernels.pagerank_spmv.update import pack_graph
from test_torch_common import CPU, np_, port_graph, port_update

N = 48


def _graphs(seed=0, n=N, m=150, extra=256):
    rng = np.random.default_rng(seed)
    init = np.unique(rng.integers(0, n, size=(m, 2)), axis=0)
    init = init[init[:, 0] != init[:, 1]]
    jg = j_from_coo(init[:, 0], init[:, 1], n,
                    edge_capacity=len(init) + extra)
    return jg, port_graph(jg)


def _assert_sharded_equal(t, j, what=""):
    for f in sh.FIELDS:
        a, b = t.stacked(f), np_(getattr(j, f))
        assert a.shape == b.shape and np.array_equal(a, b), (what, f)


def _assert_routed_equal(t, j):
    for a, b in zip(t, j):
        assert np.array_equal(np_(a), np_(b))


CASES = [(1, 16, 8, 16), (2, 16, 8, 16), (4, 16, 8, 16), (4, 32, 16, 1),
         (3, 8, 4, 8)]


@pytest.mark.parametrize("shards,be,vb,spill", CASES)
def test_pack_shards_equals_reference(shards, be, vb, spill):
    jg, tg = _graphs(0)
    jp, jspec = jsh.pack_shards(jg, shards, be=be, vb=vb,
                                spill_lanes_per_window=spill,
                                extra_entries=24, overlay_capacity=64)
    tp, tspec = sh.pack_shards(tg, shards, be=be, vb=vb,
                               spill_lanes_per_window=spill,
                               extra_entries=24, overlay_capacity=64)
    assert tuple(tspec) == tuple(jspec)
    assert tspec.padded_vertices == jspec.padded_vertices
    _assert_sharded_equal(tp, jp)
    assert sh.sharded_edge_set(tp, tspec) == jsh.sharded_edge_set(jp, jspec)
    assert all(p.device.type == "cpu" for p in tp.shards)


def test_sharded_pack_errors_match_reference():
    jg, tg = _graphs(0)
    with pytest.raises(ValueError, match="spill_lanes_per_window >= 1"):
        sh.pack_shards(tg, 2, be=16, vb=8, spill_lanes_per_window=0)
    with pytest.raises(ValueError, match="num_shards"):
        sh.pack_shards(tg, 0)
    with pytest.raises(ValueError, match="max_entries_per_window"):
        sh.pack_shards(tg, 2, be=4, vb=8, max_entries_per_window=1)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_stream_route_apply_halo_equal_reference(shards):
    """Twelve batches of the reference's differential stream through both
    packages' mesh-free sharded update: routed rows, packed leaves, halo
    table and wire bytes equal after every batch."""
    init, n, batches = update_stream(5, 4, regime="mixed", num_batches=12,
                                     batch_size=12, seed=21)
    cap = len(init) + 12 * 32 + 64
    jg = j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap)
    tg = port_graph(jg)
    kw = dict(be=32, vb=16, spill_lanes_per_window=64)
    jp, jspec = jsh.pack_shards(jg, shards, **kw)
    tp, tspec = sh.pack_shards(tg, shards, **kw)
    jh, th = jsh.build_halo(jp, jspec), sh.build_halo(tp, tspec)
    for b, (dels, ins) in enumerate(batches):
        ju = j_make_update(dels, ins, 8, 16)
        tu = port_update(ju)
        jr = jsh.route_update(ju, jspec)
        tr = sh.route_update(tu, tspec)
        _assert_routed_equal(tr, jr)
        jp = jsh.apply_batch_sharded_host(jp, jspec, ju)
        tp = sh.apply_batch_sharded_host(tp, tspec, tu)
        _assert_sharded_equal(tp, jp, f"batch {b}")
        jh = jsh.extend_halo(jh, jr, jspec)
        th = sh.extend_halo(th, tr, tspec)
        assert np.array_equal(np_(th.ids), np_(jh.ids)), b
        assert np.array_equal(np_(th.count), np_(jh.count)), b
        assert sh.halo_slots(th) == jsh.halo_slots(jh)
        assert sh.halo_occupancy(th) == jsh.halo_occupancy(jh)
        for wire in ("packed", "quantized"):
            for expand in (True, False):
                assert halo_comm_bytes(th, b + 3, wire=wire,
                                       expand=expand) == j_comm_bytes(
                    jh, b + 3, wire=wire, expand=expand)
    # a rebuild from the streamed pack equals the reference's too
    assert np.array_equal(np_(sh.build_halo(tp, tspec).ids),
                          np_(jsh.build_halo(jp, jspec).ids))


def test_halo_capacity_errors_match_reference():
    jg, tg = _graphs(3, m=200)
    jp, jspec = jsh.pack_shards(jg, 4, be=16, vb=8,
                                spill_lanes_per_window=16)
    tp, tspec = sh.pack_shards(tg, 4, be=16, vb=8,
                               spill_lanes_per_window=16)
    with pytest.raises(jsh.ShardCapacityError) as je:
        jsh.build_halo(jp, jspec, capacity=2)
    with pytest.raises(sh.ShardCapacityError) as te:
        sh.build_halo(tp, tspec, capacity=2)
    assert te.value.shards == je.value.shards
    # a tight pinned halo overflows on extension as the reference does
    jh = jsh.build_halo(jp, jspec, capacity=int(
        max(np.asarray(jsh.build_halo(jp, jspec).count))))
    th = sh.build_halo(tp, tspec, capacity=int(jh.ids.shape[1]))
    ins = np.asarray([[u, 40 + (u % 8)] for u in range(12) if u != 40],
                     np.int32)
    ju = j_make_update(np.zeros((0, 2), np.int32), ins, 4, 16)
    tu = port_update(ju)
    jr, tr = jsh.route_update(ju, jspec), sh.route_update(tu, tspec)
    with pytest.raises(jsh.ShardCapacityError) as je:
        jsh.extend_halo(jh, jr, jspec)
    with pytest.raises(sh.ShardCapacityError) as te:
        sh.extend_halo(th, tr, tspec)
    assert te.value.shards == je.value.shards


def test_route_budget_overflow_matches_reference():
    jg, tg = _graphs(0)
    _, jspec = jsh.pack_shards(jg, 4, be=16, vb=8, spill_lanes_per_window=16)
    tp, tspec = sh.pack_shards(tg, 4, be=16, vb=8, spill_lanes_per_window=16)
    ins = np.asarray([[i, 1] for i in range(2, 8)], np.int32)
    ju = j_make_update(np.zeros((0, 2), np.int32), ins, 4, 8)
    with pytest.raises(sh.ShardCapacityError,
                       match="per-shard delta budget") as e:
        sh.route_update(port_update(ju), tspec, ins_budget=2)
    assert e.value.shards == (0,)
    # within budget: routed rows equal the reference's at that budget
    _assert_routed_equal(sh.route_update(port_update(ju), tspec,
                                         ins_budget=6, del_budget=3),
                         jsh.route_update(ju, jspec, ins_budget=6,
                                          del_budget=3))
    live = sorted(sh.sharded_edge_set(tp, tspec))
    s0 = [e for e in live if e[1] < tspec.vertices_per_shard][:4]
    upd = make_batch_update(np.asarray(s0, np.int32),
                            np.zeros((0, 2), np.int32), 8, 4, device=CPU)
    with pytest.raises(sh.ShardCapacityError, match="delta budget"):
        sh.route_update(upd, tspec, del_budget=2)


def test_spill_overflow_names_the_shard():
    jg, tg = _graphs(1)
    tp, tspec = sh.pack_shards(tg, 4, be=16, vb=8, spill_lanes_per_window=1,
                               overlay_capacity=8)
    vps = tspec.vertices_per_shard
    lo = 2 * vps
    ins = np.asarray([[u, lo] for u in range(40) if u != lo], np.int32)
    upd = make_batch_update(np.zeros((0, 2), np.int32), ins, 4, 64,
                            device=CPU)
    with pytest.raises(sh.ShardCapacityError) as e:
        sh.apply_batch_sharded_host(tp, tspec, upd)
    assert e.value.shards == (2,)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_shard_spmv_assembles_the_unsharded_one(shards, frac):
    """Each shard's gated SpMV over the full rsc, its windows
    concatenated, equals the unsharded call bit for bit (the same lanes
    in the same order a window) and the plain version."""
    _, tg = _graphs(2, m=300)
    be, vb = 16, 8
    tp, tspec = sh.pack_shards(tg, shards, be=be, vb=vb,
                               spill_lanes_per_window=16)
    whole = pack_graph(tg, be=be, vb=vb, spill_lanes_per_window=16)
    rng = np.random.default_rng(shards)
    rsc = torch.from_numpy(rng.random(tspec.padded_vertices)
                           .astype(np.float32))
    aff = torch.from_numpy(rng.random(tspec.padded_vertices) < frac)
    awin = aff.reshape(-1, vb).any(dim=1)
    wps = tspec.windows_per_shard
    parts = [sh.frontier_spmv_shard(p, rsc, awin[s * wps:(s + 1) * wps])
             for s, p in enumerate(tp.shards)]
    got = torch.cat(parts)
    nw = whole.num_windows
    want = frontier_spmv_ref_padded(whole.src, whole.dst_rel, whole.valid,
                                    whole.window, rsc, awin[:nw], vb)
    assert torch.equal(got[:nw * vb], want)
    assert not got[nw * vb:].any()
    plain = [sh.frontier_spmv_shard(p, rsc, awin[s * wps:(s + 1) * wps],
                                    use_kernel=False)
             for s, p in enumerate(tp.shards)]
    assert torch.equal(torch.cat(plain), got)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sh.frontier_spmv_shard(tp.shards[0], rsc, awin[:wps],
                               use_kernel=True)


# ---------------------------------------------------------------------------
# collectives: a NumPy transcription of the reference's formula
# ---------------------------------------------------------------------------

def _np_int8_psum(xs):
    xf = [np.asarray(x, np.float32) for x in xs]
    if xf[0].ndim >= 2:
        amax = np.max([np.max(np.abs(x), axis=-1, keepdims=True)
                       for x in xf], axis=0)
    else:
        amax = np.max([np.max(np.abs(x)) for x in xf])
    scale = (np.maximum(amax, np.float32(1e-30)) / np.float32(127.0)
             ).astype(np.float32)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8)
         for x in xf]
    wire = np.sum([x.astype(np.int16) for x in q], axis=0, dtype=np.int16)
    return wire.astype(np.float32) * scale


@pytest.mark.parametrize("shape,shards", [((33,), 2), ((5, 17), 4),
                                          ((3, 4, 9), 3), ((64,), 1)])
def test_int8_psum_equals_numpy_transcription(shape, shards):
    rng = np.random.default_rng(len(shape) * 10 + shards)
    xs = [rng.standard_normal(shape).astype(np.float32) * (s + 1)
          for s in range(shards)]
    got = int8_psum([torch.from_numpy(x) for x in xs])
    want = _np_int8_psum(xs)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the error bound: n_shards * max|x| / 127 / 2 a row
    exact = np.sum(xs, axis=0)
    bound = shards * np.max(np.abs(xs)) / 127 / 2 * 1.0001
    assert np.max(np.abs(got.numpy() - exact)) <= bound
    assert torch.equal(int8_psum([torch.from_numpy(x) for x in xs]), got)


def test_bool_or_psum_is_exact_or():
    rng = np.random.default_rng(5)
    flags = [rng.random((7, 33)) < 0.2 for _ in range(4)]
    got = bool_or_psum([torch.from_numpy(f) for f in flags])
    assert np.array_equal(got.numpy(), np.logical_or.reduce(flags))
    assert np.array_equal(
        got.numpy(), _np_int8_psum([f.astype(np.float32)
                                    for f in flags]) > 0.5)
    with pytest.raises(ValueError, match="overflow"):
        int8_psum([torch.zeros(2)] * (MAX_WIRE_SHARDS + 1))
