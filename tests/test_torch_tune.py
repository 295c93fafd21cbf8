"""Port parity: the pack-geometry tuner (``repro_torch.kernels.
pagerank_spmv.tune``) against ``repro.kernels.pagerank_spmv.tune``.

Sizing, keys and the cache are the reference's, bit for bit: the spill
rule, the shape signature, each window's entry count (also against what
both packages' ``pack_blocks`` pack), the JSON file.  The ranking model is
the port's own (a model of the Hopper kernel, not the TPU's roofline), so
it is held to its own properties: it covers the grid, it is deterministic,
and at 100 % active it prefers wide windows.  The serve engine tunes at
bootstrap unless ``be``/``vb`` are given, as the reference's does.
"""
import json

import numpy as np
import pytest

import repro  # noqa: F401
from repro.graph.generators import rmat_edges as j_rmat
from repro.graph.structure import from_coo as j_from_coo
from repro.kernels.pagerank_spmv import tune as jtune
from repro.kernels.pagerank_spmv.update import pack_graph as j_pack_graph

from repro_torch.kernels.pagerank_spmv import tune
from repro_torch.kernels.pagerank_spmv.update import pack_graph
from repro_torch.serve import IngestQueue, RankStore, ServeEngine
from test_torch_common import CPU, np_, port_graph


def _graphs(scale=9, edge_factor=6, seed=11, extra=512):
    edges, n = j_rmat(scale, edge_factor, seed=seed)
    jg = j_from_coo(edges[:, 0], edges[:, 1], n,
                    edge_capacity=len(edges) + extra)
    return jg, port_graph(jg)


def _live_dst(g):
    return np_(g.dst)[np_(g.valid)]


# ---------------------------------------------------------------------------
# the reference's arithmetic, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("windows,inserts,be", [
    (100, 0, 512), (1, 10**9, 512), (64, 1024, 512), (8192, 65536, 256),
    (3, 7, 2048), (16384, 65536, 1024)])
def test_spill_for_stream_equals_reference(windows, inserts, be):
    got = tune.spill_for_stream(windows, inserts, be)
    assert got == jtune.spill_for_stream(windows, inserts, be)
    assert 16 <= got <= be and got & (got - 1) == 0


@pytest.mark.parametrize("n,e,f", [
    (1000, 8000, 0.05), (1100, 8800, 0.06), (4000, 8000, 0.05),
    (1000, 8000, 0.005), (2 ** 21, 32_416_274, 1.0), (2, 1, 1e-9)])
def test_graph_signature_equals_reference(n, e, f):
    assert tune.graph_signature(n, e, f) == jtune.graph_signature(n, e, f)


@pytest.mark.parametrize("be,vb", [(256, 128), (512, 256), (2048, 512),
                                   (32, 16)])
def test_window_entries_equal_both_packs(be, vb):
    """The model's per-window entries are the reference's sizing and what
    either package's pack gives each window."""
    jg, tg = _graphs()
    n = tg.num_vertices
    dst = _live_dst(jg)
    spill = jtune.spill_for_stream(-(-n // vb), 1024, be)
    got = tune.window_entries(dst, n, be, vb, spill)
    # the reference's own arithmetic, as _geometry_cost writes it
    nw = -(-n // vb)
    counts = np.bincount(dst // vb, minlength=nw).astype(np.int64)
    n_base = -(-counts // be)
    need = np.maximum(0, spill - (n_base * be - counts))
    assert np.array_equal(got, n_base + -(-need // be))
    tp = pack_graph(tg, be=be, vb=vb, spill_lanes_per_window=spill)
    jp = j_pack_graph(jg, be=be, vb=vb, spill_lanes_per_window=spill)
    assert np.array_equal(np.diff(np_(tp.entry_start)), got)
    assert np.array_equal(np.diff(np_(jp.entry_start)), got)


def test_cache_file_is_the_references_format(tmp_path):
    """Round trip, and a file of either package reads in the other."""
    geom = tune.KernelGeometry(be=1024, vb=256, spill_lanes_per_window=64)
    path = str(tmp_path / "port.json")
    tune.TuneCache(path).put("k", geom)
    reloaded = tune.TuneCache(path)
    assert len(reloaded) == 1 and reloaded.get("k") == geom
    with open(path) as f:
        assert json.load(f) == {"k": dict(be=1024, vb=256,
                                          spill_lanes_per_window=64)}
    assert jtune.TuneCache(path).get("k") == jtune.KernelGeometry(
        be=1024, vb=256, spill_lanes_per_window=64)
    jpath = str(tmp_path / "ref.json")
    jtune.TuneCache(jpath).put("j", jtune.KernelGeometry(256, 128, 16))
    with open(jpath) as a, open(str(tmp_path / "port.json")) as b:
        assert set(json.load(a)) == {"j"} and set(json.load(b)) == {"k"}
    assert tune.TuneCache(jpath).get("j") == tune.KernelGeometry(256, 128,
                                                                 16)


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", '{"k": 3}',
                                  '{"k": {"be": 1}}'])
def test_cache_tolerates_corrupt_file(tmp_path, text):
    """A corrupt file reads as empty (the reference's raises on a JSON
    list; the port reads that as empty too)."""
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        f.write(text)
    cache = tune.TuneCache(path)
    assert len(cache) == 0
    if text != "[1, 2]":
        assert len(jtune.TuneCache(path)) == 0
    cache.put("k", tune.KernelGeometry(be=256, vb=128,
                                       spill_lanes_per_window=16))
    assert tune.TuneCache(path).get("k") is not None


def test_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    path = tune.default_cache_path()
    assert path.endswith("/.cache/repro_torch/kernel_tune.json")
    assert path != jtune.default_cache_path()
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/elsewhere/ref.json")
    assert tune.default_cache_path() == path
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/x/port.json")
    assert tune.default_cache_path() == "/x/port.json"


def test_cache_miss_then_hit_keys_as_the_reference(tmp_path):
    path = str(tmp_path / "tune.json")
    jg, tg = _graphs()
    geom1, info1 = tune.tune_geometry(tg, cache_path=path)
    assert info1.source == "model" and not info1.cache_hit
    assert len(info1.candidates) == len(tune.CANDIDATE_GRID)
    _, jinfo = jtune.tune_geometry(jg, cache_path=str(tmp_path / "j.json"))
    assert info1.key == jinfo.key            # "cpu/v2^..-e2^..-f1e-1"
    assert tune.device_kind(CPU) == "cpu"
    geom2, info2 = tune.tune_geometry(tg, cache_path=path)
    assert info2.source == "cache" and info2.cache_hit
    assert geom2 == geom1 and info2.key == info1.key


def test_frontier_decade_changes_key(tmp_path):
    path = str(tmp_path / "tune.json")
    _, tg = _graphs()
    _, a = tune.tune_geometry(tg, frontier_frac=0.05, cache_path=path)
    _, b = tune.tune_geometry(tg, frontier_frac=0.005, cache_path=path)
    assert a.key != b.key and not b.cache_hit
    _, c = tune.tune_geometry(tg, frontier_frac=0.04, cache_path=path)
    assert c.key == a.key and c.cache_hit


# ---------------------------------------------------------------------------
# the port's model: its own properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.0, 0.01, 0.05, 1.0])
def test_model_covers_grid_and_is_deterministic(frac):
    jg, _ = _graphs()
    dst = _live_dst(jg)
    n = jg.num_vertices
    ranked = tune.candidate_costs(dst, n, frac, 1024)
    assert {(g.be, g.vb) for g, _ in ranked} == set(tune.CANDIDATE_GRID)
    costs = [c for _, c in ranked]
    assert costs == sorted(costs) and all(c > 0 for c in costs)
    assert ranked == tune.candidate_costs(dst.copy(), n, frac, 1024)
    for g, _ in ranked:
        assert g.spill_lanes_per_window == tune.spill_for_stream(
            -(-n // g.vb), 1024, g.be)


def test_model_prefers_wide_windows_at_full_frontier():
    """At 100 % active on a graph large enough that its chunks take
    several waves of the grid (2^20 vertices, 5.2 M skewed in-edges; the
    histogram alone, no edge list), wider windows mean fewer chunks and
    rounds: at every BE the model ranks VB 512 above 256 above 128, and
    its pick has the widest windows."""
    n = 2 ** 20
    deg = np.minimum((128.0 * (np.arange(n) + 1.0) ** -0.25)
                     .astype(np.int64), 100_000)
    dst = np.repeat(np.arange(n, dtype=np.int32), deg)
    ranked = tune.candidate_costs(dst, n, 1.0, 0)
    cost = {(g.be, g.vb): c for g, c in ranked}
    for be in (256, 512, 1024, 2048):
        assert cost[(be, 512)] < cost[(be, 256)] < cost[(be, 128)], be
    assert ranked[0][0].vb == 512 and ranked[-1][0].vb == 128


def test_model_terms_follow_the_kernel():
    """More active windows, more gathers; no active window, the floor;
    the grid is the resident wave of 256-thread blocks."""
    jg, _ = _graphs()
    dst = _live_dst(jg)
    n = jg.num_vertices
    nw = -(-n // 256)
    counts = np.bincount(dst // 256, minlength=nw)
    n_w = tune.window_entries(dst, n, 512, 256, 16)
    zero = tune.gated_spmv_cost(counts, n_w, n, 512, 256, 0.0)
    half = tune.gated_spmv_cost(counts, n_w, n, 512, 256, 0.5)
    full = tune.gated_spmv_cost(counts, n_w, n, 512, 256, 1.0)
    assert zero["live"] == 0 and zero["total_s"] == tune.HOST_CALL_S
    assert zero["live"] < half["live"] < full["live"] == len(dst)
    assert zero["device_s"] < half["device_s"] < full["device_s"]
    assert full["active_windows"] == nw
    assert tune.resident_blocks(256) == 4      # 64 registers x 256 threads
    assert tune.resident_blocks(1024) == 4


def test_measured_search_times_top_candidates(tmp_path):
    path = str(tmp_path / "tune.json")
    _, tg = _graphs(scale=8)
    geom, info = tune.tune_geometry(tg, cache_path=path, measure=True,
                                    measure_top=2, use_kernel=False)
    assert info.source == "measured"
    timed = [c for c in info.candidates if c[2] is not None]
    assert len(timed) == 2 and all(t > 0 for _, _, t in timed)
    assert geom == min(timed, key=lambda c: c[2])[0]
    assert tune.TuneCache(path).get(info.key) == geom


# ---------------------------------------------------------------------------
# the serve engine tunes at bootstrap, as the reference's does
# ---------------------------------------------------------------------------

def _engine(g, **kernel_opts):
    return ServeEngine(g, IngestQueue(flush_size=8, flush_interval=1e9,
                                      max_pending=1024, device=CPU),
                       RankStore(), method="frontier", engine="kernel",
                       kernel_opts=kernel_opts)


def test_serve_bootstrap_tunes_and_hits_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    _, tg = _graphs(scale=8)
    eng = _engine(tg)
    eng.bootstrap()
    geom = eng.kernel_geometry
    assert eng.tune_info is not None and not eng.tune_info.cache_hit
    assert (geom.be, geom.vb) in tune.CANDIDATE_GRID
    assert (eng.packed.be, eng.packed.vb) == (geom.be, geom.vb)
    want, _ = tune.tune_geometry(tg, expected_inserts=1024,
                                 cache_path=str(tmp_path / "fresh.json"))
    assert geom == want              # expected inserts max(1024, 64 x 8)
    eng2 = _engine(tg)
    eng2.bootstrap()
    assert eng2.tune_info.cache_hit and eng2.kernel_geometry == geom
    assert eng2.metrics.as_dict().get("tune_cache_hit_rate", 1.0) == 1.0


def test_serve_explicit_geometry_disables_tuning(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    _, tg = _graphs(scale=8)
    eng = _engine(tg, be=32, vb=16, spill_lanes_per_window=64)
    eng.bootstrap()
    assert eng.tune_info is None
    assert (eng.kernel_geometry.be, eng.kernel_geometry.vb) == (32, 16)
    assert not (tmp_path / "t.json").exists()
    # tune=True with an explicit be: the explicit key still wins
    eng = _engine(tg, be=64, tune=True,
                  tune_cache_path=str(tmp_path / "named.json"))
    eng.bootstrap()
    assert eng.tune_info is not None and eng.kernel_geometry.be == 64
    assert (tmp_path / "named.json").exists()
    # tune=False keeps the serving defaults
    eng = _engine(tg, tune=False)
    eng.bootstrap()
    assert eng.tune_info is None
    assert (eng.kernel_geometry.be, eng.kernel_geometry.vb) == (512, 256)
