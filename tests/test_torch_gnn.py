"""Port parity: the DF-frontier GNN embedding refresh and the gated
segment-SpMM's plain version, against ``repro``.

  * the port's plain ``gated_spmm`` (through ``aggregate_features``)
    against the reference's ``aggregate_features`` with ``use_kernel=False``
    and with its Pallas kernel in interpret mode, before and after a batch:
    rtol 1e-4 / atol 1e-5, the tolerance of ``tests/test_kernels.py``
    (f32 sums in different orders); inactive windows exactly 0;
  * ``sage_forward`` with carried parameters at ``SMOKE`` and at full width:
    atol 1e-5 times the output's largest magnitude (f32 sums and products
    in different orders);
  * chunked aggregation against one chunk: the same tolerance;
  * ``incremental_refresh``: ``affected_ever`` and ``nodes_recomputed``
    equal, embeddings within the tolerance above, and at τ_f = 0 exact
    against a full forward, as ``tests/test_substrate.py`` holds the
    reference.

The CUDA kernel itself needs the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""
import functools

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp
from repro.configs import graphsage_reddit as jcfg
from repro.core.incremental_gnn import incremental_refresh as j_refresh
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.kernels.pagerank_spmv import pagerank_spmv as jspmv
from repro.kernels.pagerank_spmv import update as jupd
from repro.kernels.segment_ops.ops import aggregate_features as j_agg
from repro.models import gnn as jgnn

from repro_torch import convert
from repro_torch.configs import graphsage_reddit as tcfg
from repro_torch.core.incremental_gnn import incremental_refresh as t_refresh
from repro_torch.kernels.pagerank_spmv import update as tupd
from repro_torch.kernels.pull_contrib import ref as pcref
from repro_torch.kernels.segment_ops import ref as tref
from repro_torch.kernels.segment_ops import segment_matmul as tsm
from repro_torch.kernels.segment_ops.ops import aggregate_features as t_agg
from repro_torch.models import gnn as tgnn
from test_torch_common import CPU, np_, port_graph, port_packed, port_update

RTOL, ATOL = 1e-4, 1e-5


def _close_scaled(out, ref, what=""):
    """max |out - ref| <= 1e-5 x the largest |ref| (at least 1)."""
    out, ref = np_(out), np_(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= ATOL * scale, (what, err, scale)


def _assert_inactive_zero(out, packed, affected):
    nw, vb = packed.num_windows, packed.vb
    aff = np.zeros(nw * vb, bool)
    aff[:len(affected)] = affected
    inactive = ~np.repeat(aff.reshape(nw, vb).any(axis=1),
                          vb)[:packed.num_vertices]
    assert np.all(np_(out)[inactive] == 0.0)


# ---------------------------------------------------------------------------
# the plain gated segment-SpMM against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _spmm_case(d):
    """(reference packed graph, features, affected mask, reference outputs
    without and with its kernel), as ``tests/test_kernels.py`` builds them."""
    edges, n = jgen.rmat_edges(7, 6, seed=d)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=128, vb=128)
    rng = np.random.default_rng(d)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    aff = rng.random(n) < 0.5
    ref = {k: np.asarray(j_agg(jp, jnp.asarray(feats), jnp.asarray(aff),
                               use_kernel=k)) for k in (False, True)}
    return jp, feats, aff, ref


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("d", [16, 64, 130])
def test_gated_spmm_plain_matches_reference(d, use_kernel):
    jp, feats, aff, ref = _spmm_case(d)
    tp = port_packed(jp)
    before = dict(tsm.LAUNCH_COUNTS)
    out = t_agg(tp, torch.from_numpy(feats), torch.from_numpy(aff))
    assert out.dtype == torch.float32 and out.shape == (jp.num_vertices, d)
    np.testing.assert_allclose(out.numpy(), ref[use_kernel], rtol=RTOL,
                               atol=ATOL)
    _assert_inactive_zero(out, tp, aff)
    assert 0 < aff.sum() < len(aff)
    assert dict(tsm.LAUNCH_COUNTS) == before     # the plain version ran


@pytest.mark.parametrize("case", ["empty_graph", "no_active_window"])
def test_gated_spmm_zero_cases(case):
    if case == "empty_graph":
        none = np.zeros(0, np.int32)
        jp = jspmv.pack_blocks(none, none, none.astype(bool), 256, be=128,
                               vb=128)
        aff = np.ones(256, bool)
    else:
        jp, _, _, _ = _spmm_case(16)
        aff = np.zeros(jp.num_vertices, bool)
    feats = np.random.default_rng(0).standard_normal(
        (jp.num_vertices, 24)).astype(np.float32)
    # the reference's plain path: its Pallas kernel never writes an active
    # window that owns no entry (NaN in interpret mode on the empty graph;
    # ROADMAP §3)
    ref = np.asarray(j_agg(jp, jnp.asarray(feats), jnp.asarray(aff),
                           use_kernel=False))
    out = t_agg(port_packed(jp), torch.from_numpy(feats),
                torch.from_numpy(aff))
    assert float(np.abs(ref).max()) == 0.0
    assert out.shape == (jp.num_vertices, 24)
    assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("d", [16, 130])
def test_gated_spmm_after_batch_matches_reference(d):
    edges, n = jgen.rmat_edges(7, 6, seed=5)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 64)
    kw = dict(be=128, vb=32, spill_lanes_per_window=16)
    jp = jupd.pack_graph(jg, **kw)
    tp = tupd.pack_graph(port_graph(jg), **kw)
    dele, ins = jgen.random_batch_update(edges, n, 24, seed=d)
    ju = jdyn.make_batch_update(dele, ins, 32, 32)
    jp = jupd.apply_batch_packed(jp, ju)
    tp = tupd.apply_batch_packed(tp, port_update(ju))
    rng = np.random.default_rng(d)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    touched = jdyn.touched_vertices_mask(ju, n)
    aff = np.array(touched | jdyn.apply_batch(jg, ju).push_or(touched))
    out = t_agg(tp, torch.from_numpy(feats), torch.from_numpy(aff))
    for use_kernel in (False, True):
        ref = j_agg(jp, jnp.asarray(feats), jnp.asarray(aff),
                    use_kernel=use_kernel)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    _assert_inactive_zero(out, tp, aff)


def test_gated_spmm_wrapper_dispatch():
    jp, feats, aff, _ = _spmm_case(16)
    tp = port_packed(jp)
    awin = tp.active_windows(torch.from_numpy(aff))
    f = torch.from_numpy(feats)
    # a meta ``feats`` runs the launch path (the dry-run's device): the
    # packed structure must lie there too
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        tsm.gated_spmm(tp, f.to("meta"), awin)
    with pytest.raises(ValueError, match="feats must be"):
        tsm.gated_spmm(tp, f[:-1], awin)
    # feats are cast to f32, as the reference casts them
    out = tsm.gated_spmm(tp, f.to(torch.float64), awin)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, tsm.gated_spmm(tp, f, awin))


# ---------------------------------------------------------------------------
# GraphSAGE
# ---------------------------------------------------------------------------

def _sage_pair(cfg_name, seed=0):
    jc, tc = getattr(jcfg, cfg_name), getattr(tcfg, cfg_name)
    jparams = jgnn.init_sage(jc, jax.random.PRNGKey(seed))
    tparams = convert.sage_params_from_numpy(
        [{k: tuple(np.asarray(a) for a in lp[k]) for k in lp}
         for lp in jparams], device=CPU)
    return jc, tc, jparams, tparams


def _j_batch(g, x):
    return jgnn.GraphBatch(node_feats=x, edge_src=g.src, edge_dst=g.dst,
                           edge_mask=g.valid,
                           node_mask=jnp.ones((g.num_vertices,), bool))


def _t_batch(g, x):
    return tgnn.GraphBatch(node_feats=x, edge_src=g.src, edge_dst=g.dst,
                           edge_mask=g.valid,
                           node_mask=torch.ones(g.num_vertices,
                                                dtype=torch.bool))


def test_configs_match_reference():
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}


@pytest.mark.parametrize("cfg_name", ["SMOKE", "CONFIG"])
def test_sage_forward_matches_reference(cfg_name):
    jc, tc, jparams, tparams = _sage_pair(cfg_name)
    edges, n = jgen.rmat_edges(6, 6, seed=3)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 32)
    x = np.random.default_rng(1).standard_normal(
        (n, jc.d_in)).astype(np.float32)
    ref = jgnn.sage_forward(jc, jparams, _j_batch(jg, jnp.asarray(x)))
    out = tgnn.sage_forward(tc, tparams,
                            _t_batch(port_graph(jg), torch.from_numpy(x)))
    assert out.shape == (n, tc.n_classes) and out.dtype == torch.float32
    _close_scaled(out, ref, cfg_name)
    # `affected` is accepted and ignored, as in the reference
    again = tgnn.sage_forward(tc, tparams,
                              _t_batch(port_graph(jg), torch.from_numpy(x)),
                              affected=torch.zeros(n, dtype=torch.bool))
    assert torch.equal(out, again)


@pytest.mark.parametrize("cfg_name", ["SMOKE", "CONFIG"])
def test_sage_forward_with_hub_matches_reference(cfg_name):
    """A hub of 400 in-edges: the port cuts its neighbour sum into chunks
    (``pull_rows``, 64 slots a chunk) and adds them in chunk order."""
    jc, tc, jparams, tparams = _sage_pair(cfg_name, seed=1)
    rng = np.random.default_rng(5)
    n = 600
    src = np.concatenate([rng.permutation(n)[:400],
                          rng.integers(0, n, 1200)])
    dst = np.concatenate([np.zeros(400, np.int64), rng.integers(0, n, 1200)])
    keep = src != dst
    jg = jstr.from_coo(src[keep], dst[keep], n)
    x = rng.standard_normal((n, jc.d_in)).astype(np.float32)
    ref = jgnn.sage_forward(jc, jparams, _j_batch(jg, jnp.asarray(x)))
    tg = port_graph(jg)
    assert int(tg.in_degree(False)[0]) >= 399
    out = tgnn.sage_forward(tc, tparams, _t_batch(tg, torch.from_numpy(x)))
    _close_scaled(out, ref, cfg_name)


def test_init_sage_layout():
    gen = torch.Generator().manual_seed(0)
    params = tgnn.init_sage(tcfg.CONFIG, gen)
    shapes = [{k: [tuple(t.shape) for t in lp[k]] for k in lp}
              for lp in params.layers]
    assert shapes == [{k: [(602, 128), (128,)] for k in ("w_self",
                                                         "w_neigh")},
                      {k: [(128, 41), (41,)] for k in ("w_self",
                                                       "w_neigh")}]
    w, b = params.layers[0]["w_self"]
    # trainable (the train step); serving runs under torch.no_grad()
    assert w.requires_grad and float(b.abs().max()) == 0.0
    assert abs(float(w.std()) * 602 ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("which", ["neighbor_sum", "gated_spmm_ref"])
def test_chunked_aggregation_equals_one_chunk(which, monkeypatch):
    edges, n = jgen.rmat_edges(6, 6, seed=4)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, 33)).astype(np.float32))
    if which == "neighbor_sum":
        g = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n,
                                     edge_capacity=len(edges) + 21))

        def run():
            return tgnn.neighbor_sum(x, g.src, g.dst, g.valid, n)
        module, small = pcref, 7         # 7 edge slots a chunk
    else:
        p = port_packed(jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                                          np.ones(len(edges), bool), n,
                                          be=16, vb=16))
        awin = torch.ones(p.num_windows, dtype=torch.bool)

        def run():
            return tref.gated_spmm_ref(p.src, p.dst_rel, p.valid, p.window,
                                       x, awin, n, p.vb)
        module, small = tref, 7 * 16    # 7 entries a chunk
    whole = run()
    name = "EDGE_CHUNK" if which == "neighbor_sum" else "LANE_CHUNK"
    monkeypatch.setattr(module, name, small)
    chunked = run()
    assert float(whole.abs().max()) > 0
    _close_scaled(chunked, whole, which)


# ---------------------------------------------------------------------------
# incremental refresh
# ---------------------------------------------------------------------------

def _refresh_case(frontier_tol, own_old=False):
    """The reference's and the port's refresh of one batch on R-MAT scale
    7 at SMOKE, from the reference's old embeddings or (``own_old``) from
    each package's own."""
    jc, tc, jparams, tparams = _sage_pair("SMOKE")
    edges, n = jgen.rmat_edges(7, 6, seed=9)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 64)
    x = np.random.default_rng(0).standard_normal(
        (n, jc.d_in)).astype(np.float32)

    def j_fwd(g, f):
        return jgnn.sage_forward(jc, jparams, _j_batch(g, f))

    def t_fwd(g, f):
        return tgnn.sage_forward(tc, tparams, _t_batch(g, f))

    old = j_fwd(jg, jnp.asarray(x))
    dele, ins = jgen.random_batch_update(edges, n, 6, seed=1)
    ju = jdyn.make_batch_update(dele, ins, 16, 16)
    jg2 = jdyn.apply_batch(jg, ju)
    touched = jdyn.touched_vertices_mask(ju, n)
    ref = j_refresh(jg2, jnp.asarray(x), old, touched, layer_fn=j_fwd,
                    n_layers=jc.n_layers, frontier_tol=frontier_tol)
    tg2 = port_graph(jg2)
    t_old = (t_fwd(port_graph(jg), torch.from_numpy(x)) if own_old
             else torch.from_numpy(np_(old)))
    out = t_refresh(tg2, torch.from_numpy(x), t_old,
                    torch.from_numpy(np_(touched)), layer_fn=t_fwd,
                    n_layers=tc.n_layers, frontier_tol=frontier_tol)
    new_full = np_(j_fwd(jg2, jnp.asarray(x)))
    return dict(ref=ref, out=out, old=np_(old), new_full=new_full, n=n,
                jg2=jg2, t_fwd=t_fwd, tg2=tg2, x=x)


def test_incremental_refresh_matches_reference():
    tol = 1e-3
    c = _refresh_case(tol)
    ref, out, n = c["ref"], c["out"], c["n"]
    # a vertex whose relative move lies within f32 noise of τ_f can be
    # marked by one package and not the other: its out-neighbours (for
    # n_layers rounds) are then excluded, and reported, never reseeded away
    rel = (np.linalg.norm(c["new_full"] - c["old"], axis=-1)
           / np.maximum(np.linalg.norm(c["old"], axis=-1), 1e-12))
    borderline = np.flatnonzero(np.abs(rel - tol) <= 1e-5 * tol)
    excluded = np.zeros(n, bool)
    excluded[borderline] = True
    for _ in range(2):
        excluded |= np.asarray(c["jg2"].push_or(jnp.asarray(excluded)))
    if borderline.size:
        print(f"excluded (downstream of vertices within f32 noise of "
              f"tau_f): borderline {borderline.tolist()}, "
              f"{int(excluded.sum())} vertices")
    ever_ref, ever = np_(ref.affected_ever), np_(out.affected_ever)
    keep = ~excluded
    assert np.array_equal(ever[keep], ever_ref[keep])
    if not borderline.size:
        assert int(out.nodes_recomputed) == int(ref.nodes_recomputed)
    assert out.nodes_recomputed.dtype == torch.int64
    assert out.rounds == int(ref.rounds)
    assert 0 < int(out.nodes_recomputed) < n
    _close_scaled(np_(out.embeddings)[keep], np_(ref.embeddings)[keep],
                  "embeddings")


def test_incremental_refresh_exact_at_zero_tolerance():
    # at τ_f = 0 a move of one ulp counts, so each package starts from its
    # own old embeddings: an untouched vertex's is then the same bit for bit
    c = _refresh_case(0.0, own_old=True)
    out = c["out"]
    exact = c["t_fwd"](c["tg2"], torch.from_numpy(c["x"]))
    # with τ_f = 0 the refresh must be exact on the whole receptive field
    np.testing.assert_allclose(np_(out.embeddings), np_(exact), atol=1e-5)
    assert int(out.nodes_recomputed) < c["n"]      # and still skipped work
    assert np.array_equal(np_(out.affected_ever),
                          np_(c["ref"].affected_ever))
