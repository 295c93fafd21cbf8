"""The row sum's live-segment chunk plan (``segment_ops.plan``
``live_chunk_plan``, which ``pull_contrib.pull_rows`` builds on the card),
on the CPU.

On seeded orders (a DeepFM-shaped one: 10^5 rows, 10^3 ids, most rows
empty; an R-MAT graph's order by dst with a hub and dead slots; one with
no live slot; one segment of 300 slots; dead slots last in each) and K in
{1, 2, 64}:

  * every live slot is covered once and in order, by chunks of at most K
    slots, and no empty segment has a chunk; the chunks are the non-empty
    windows' chunks of ``chunk_plan`` and the partials are numbered as
    ``ref.chunk_rows`` numbers them;
  * the plan's lengths are the bounds its module states; built over the
    slots (from the keys: the route where slots are fewer than segments)
    and over the segments (from ``ptr`` alone) it is the same plan; and on
    ``meta`` it builds to the same shapes;
  * a plain walk of the plan as the kernel walks it (the fill of the
    empty rows from ``ptr``, each chunk in slot order from +0.0, then the
    split segments' partials in chunk order) equals ``pull_rows_ref`` bit
    for bit, and the reference's ``jax.ops.segment_sum`` within the GNN
    tests' tolerance (another order of f32 adds).

The kernel itself needs the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro_torch.graph.generators import rmat_edges
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.pull_contrib.ref import chunk_rows, pull_rows_ref
from repro_torch.kernels.segment_ops import plan as plan_mod
from repro_torch.kernels.segment_ops.plan import chunk_plan, \
    live_chunk_plan, live_plan_sizes
from repro_torch.models.message import slot_order
from test_torch_gnn import ATOL, RTOL

KS = [1, 2, 64]
KINDS = ["deepfm", "rmat", "empty", "one"]


def _order(kind):
    """A seeded PullOrder with its sorted keys, dead slots last."""
    rng = np.random.default_rng(len(kind))
    if kind == "rmat":
        edges, n = rmat_edges(10, 8, seed=3)
        valid = torch.from_numpy(rng.random(len(edges)) < 0.9)
        e = torch.from_numpy(edges.astype(np.int32))
        return pc.pull_order(e[:, 0], e[:, 1], valid, n), n
    n = {"deepfm": 100_000, "empty": 5_000, "one": 1_000}[kind]
    if kind == "deepfm":
        ids = rng.integers(0, n, 1_000)
        ids[:40] = 77                           # a hot id
        ids[40:60] = n + 3                      # out of range: dead
    elif kind == "empty":
        ids = np.full(700, n)
    else:
        ids = np.r_[np.full(300, 5), np.full(9, -1)]
    order, _ = slot_order(torch.from_numpy(ids.astype(np.int32)), n)
    return order, len(ids)


def _real(plan, nv):
    real = plan.window < nv
    cut = int(real.sum())
    assert not bool(real[cut:].any())           # real chunks, then surplus
    return {f: getattr(plan, f)[:cut].numpy()
            for f in ("window", "begin", "end", "part")}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_live_plan_covers_live_slots_in_order(kind, k):
    order, _ = _order(kind)
    nv, ne = order.ptr.shape[0] - 1, order.src.shape[0]
    plan = live_chunk_plan(order.ptr, order.dst, ne, k)
    ch = _real(plan, nv)
    ptr = order.ptr.long().numpy()
    n_live = int(ptr[-1])
    size = ch["end"] - ch["begin"]
    assert np.all((size >= 1) & (size <= k))
    # the chunks tile the live slots in order
    assert np.array_equal(ch["begin"][1:], ch["end"][:-1])
    if n_live:
        assert ch["begin"][0] == 0 and ch["end"][-1] == n_live
    else:
        assert len(size) == 0
    owned = np.diff(ptr)
    per = np.bincount(ch["window"], minlength=nv)
    assert np.array_equal(per, -(-owned // k))  # none for an empty segment
    assert np.all(ch["begin"] >= ptr[ch["window"]])
    assert np.all(ch["end"] <= ptr[ch["window"] + 1])
    # chunk_plan's chunks of the non-empty windows, numbered alike
    full = chunk_plan(order.ptr, n_live, k)
    keep = (full.window < nv) & (full.end > full.begin)
    for f in ("window", "begin", "end", "part"):
        assert np.array_equal(getattr(full, f)[keep].numpy(), ch[f]), f
    split = full.split_window < nv
    live_split = plan.split_window < nv
    for f in ("split_window", "split_part", "split_count"):
        assert np.array_equal(getattr(full, f)[split].numpy(),
                              getattr(plan, f)[live_split].numpy()), f
    assert not bool(live_split[int(live_split.sum()):].any())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_live_plan_partials_numbered_as_chunk_rows(kind, k):
    order, _ = _order(kind)
    nv, ne = order.ptr.shape[0] - 1, order.src.shape[0]
    plan = live_chunk_plan(order.ptr, order.dst, ne, k)
    ch = _real(plan, nv)
    row, owner = chunk_rows(order.ptr, k)
    mine = np.empty(int(order.ptr[-1]), np.int64)
    for v, b, e, p in zip(ch["window"], ch["begin"], ch["end"], ch["part"]):
        mine[b:e] = v if p < 0 else nv + p
    assert np.array_equal(mine, row.numpy())
    parts = ch["part"] >= 0
    assert np.array_equal(ch["part"][parts], np.arange(int(parts.sum())))
    assert np.array_equal(ch["window"][parts], owner.numpy())
    assert owner.shape[0] <= plan.num_partials
    for s in range(int((plan.split_window < nv).sum())):
        v = int(plan.split_window[s])
        mine = ch["part"][(ch["window"] == v) & parts]
        assert int(plan.split_part[s]) == mine[0]
        assert int(plan.split_count[s]) == len(mine)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_live_plan_sizes_are_the_bounds(kind, k):
    order, _ = _order(kind)
    nv, ne = order.ptr.shape[0] - 1, order.src.shape[0]
    plan = live_chunk_plan(order.ptr, order.dst, ne, k)
    n_chunks, n_parts, n_splits = live_plan_sizes(nv, ne, k)
    assert (n_chunks, n_parts, n_splits) == (
        min(nv, ne) + ne // k, ne // k, min(nv, ne // (k + 1)))
    assert all(t.shape == (n_chunks,) for t in plan[:4])
    assert all(t.shape == (n_splits,) for t in plan[4:7])
    assert all(t.dtype == torch.int32 for t in plan[:7])
    assert plan.num_partials == n_parts
    # the DeepFM shape: the plan is the size of the slots, not the rows
    if kind == "deepfm":
        assert n_chunks <= 2 * ne < nv // 20
    # built over the segments (ptr alone) and over the slots (the keys):
    # the same plan
    by_windows = plan_mod._by_windows(order.ptr, k, (n_chunks, n_parts,
                                                     n_splits), 0)
    by_slots = plan_mod._by_slots(order.ptr, order.dst, ne, k,
                                  (n_chunks, n_parts, n_splits))
    for a, b, c in zip(plan[:7], by_windows[:7], by_slots[:7]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(live_chunk_plan(order.ptr, None, ne, k).window,
                       plan.window)
    # on meta: no host read, the same shapes and types
    meta = live_chunk_plan(order.ptr.to("meta"), order.dst.to("meta"), ne,
                           k)
    assert [(t.shape, t.dtype) for t in meta[:7]] == \
        [(t.shape, t.dtype) for t in plan[:7]]
    assert meta.num_partials == n_parts


def _walk(order, x, plan):
    """The kernel's launches in plain NumPy f32: the empty rows filled
    from ptr, each chunk summed in slot order from +0.0 into its row or
    partial, then each split segment's partials added in chunk order."""
    nv, d = order.ptr.shape[0] - 1, x.shape[1]
    ptr, src = order.ptr.numpy(), order.src.numpy()
    xs = x.numpy()
    out = np.full((nv, d), np.nan, np.float32)
    out[ptr[:-1] == ptr[1:]] = 0.0                    # the fill
    partial = np.full((plan.num_partials, d), np.nan, np.float32)
    for v, b, e, p in zip(*(t.numpy() for t in plan[:4])):
        if v >= nv:
            continue                                  # a surplus slot
        acc = np.zeros(d, np.float32)
        for s in range(b, e):
            acc = acc + xs[src[s]]
        if p < 0:
            out[v] = acc
        else:
            partial[p] = acc
    for v, p0, n in zip(*(t.numpy() for t in plan[4:7])):
        if v >= nv:
            break                                     # surplus from here
        for j in range(n):
            out[v] = out[v] + partial[p0 + j]
    return torch.from_numpy(out)


@pytest.mark.parametrize("d", [1, 3, 10])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_live_plan_walk_equals_pull_rows_ref(kind, k, d):
    order, n_src = _order(kind)
    rng = np.random.default_rng(d * 100 + k)
    x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(np.float32))
    nv, ne = order.ptr.shape[0] - 1, order.src.shape[0]
    plan = live_chunk_plan(order.ptr, order.dst, ne, k)
    got = _walk(order, x, plan)
    want = pull_rows_ref(order, x, chunk_slots=k)
    assert torch.equal(got, want)
    if kind == "empty":
        assert float(got.abs().max()) == 0.0
    # the reference's sum (another order of adds): within the GNN tolerance
    live = int(order.ptr[-1])
    ref = jax.ops.segment_sum(jnp.asarray(x.numpy()[order.src[:live]]),
                              jnp.asarray(order.dst[:live].numpy()),
                              num_segments=nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_row_plan_is_built_once_an_order(monkeypatch):
    """``pull_rows``' plan: the live plan of the order's keys, built at
    the first call on an order and K, then handed back as is."""
    from repro_torch.kernels.segment_ops import plan as plan_mod
    order, _ = _order("deepfm")
    builds = []

    def counted(*args):
        builds.append(args[2:])
        return live(*args)
    live = plan_mod.live_chunk_plan
    monkeypatch.setattr(plan_mod, "live_chunk_plan", counted)
    a = pc.row_plan(order, 64)
    assert pc.row_plan(order, 64) is a and len(builds) == 1
    pc.row_plan(order, 2)
    assert len(builds) == 2
    want = live(order.ptr, order.dst, order.src.shape[0], 64)
    assert all(torch.equal(x, y) for x, y in zip(a[:7], want[:7]))


@pytest.mark.parametrize("d,lanes", [(1, 1), (2, 1), (3, 4), (10, 8),
                                     (16, 4), (64, 16), (37, 32),
                                     (128, 32), (602, 32)])
def test_row_lanes_pack_narrow_rows(d, lanes):
    """A chunk's lanes: the row's vectors rounded up to a power of two
    where they fill at most half a warp, else the whole warp."""
    vec, _ = pc.row_path(d, 0)
    assert pc.row_lanes(d, vec) == lanes
    assert lanes == 32 or d // vec <= lanes < 2 * max(d // vec, 1)
