"""Port parity: block-Gauss-Seidel PageRank (``core/gauss_seidel.py``)
against ``repro.core.gauss_seidel``, and the port's independence from JAX.

The reference's two cases (R-MAT 8/8 and a 20x20 grid, packed at BE 256 /
VB 128, tol 1e-7): f32 ranks within L∞ 1e-6 of the reference's, sweeps
equal, the fixed point within L1 1e-4 of the f64 oracle, no more sweeps
than the Jacobi loop needs iterations, and every sweep bitwise equal run
to run.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core.gauss_seidel import gauss_seidel_pagerank as j_gs
from repro.core.reference import l1_error, static_pagerank_ref
from repro.graph.generators import grid_edges, rmat_edges
from repro.graph.structure import from_coo
from repro.kernels.pagerank_spmv.ops import pack_blocks

from repro_torch.core.gauss_seidel import gauss_seidel_pagerank
from repro_torch.core.kernel_engine import kernel_pagerank_loop
from test_torch_common import port_graph, port_packed

SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")


def _case(gen, seed):
    if gen == "rmat":
        edges, n = rmat_edges(8, 8, seed=seed)
    else:
        edges, n = grid_edges(20)
    g = from_coo(edges[:, 0], edges[:, 1], n, edge_capacity=len(edges) + 8)
    packed = pack_blocks(edges[:, 0], edges[:, 1],
                         np.ones(len(edges), bool), n, be=256, vb=128)
    return edges, n, g, packed


@pytest.mark.parametrize("gen,seed", [("rmat", 23), ("grid", 0)])
def test_gs_matches_reference(gen, seed):
    edges, n, g, packed = _case(gen, seed)
    ref = j_gs(g, packed, jnp.full((n,), 1.0 / n, jnp.float32), tol=1e-7)
    tg, tp = port_graph(g), port_packed(packed)
    init = torch.full((n,), 1.0 / n, dtype=torch.float32)
    out = gauss_seidel_pagerank(tg, tp, init, tol=1e-7)
    assert out.ranks.dtype == torch.float32 and out.ranks.shape == (n,)
    assert out.sweeps == int(ref.sweeps)
    linf = float(np.max(np.abs(out.ranks.numpy() - np.asarray(ref.ranks))))
    assert linf <= 1e-6
    oracle, _ = static_pagerank_ref(edges[:, 0], edges[:, 1], n, tol=1e-12)
    assert l1_error(out.ranks.numpy(), oracle) < 1e-4
    jac = kernel_pagerank_loop(tg, tp, init, torch.ones(n, dtype=torch.bool),
                               tol=1e-7, closed_form=True, expand=False)
    # the async analogue needs no more sweeps than Jacobi iterations
    assert out.sweeps <= jac.iterations
    again = gauss_seidel_pagerank(tg, tp, init, tol=1e-7)
    assert torch.equal(again.ranks, out.ranks)
    assert torch.equal(again.delta, out.delta)


def test_gs_max_sweeps_and_windows_without_entries():
    """A window that owns no entry keeps its initial ranks (the
    reference's scan never commits it); ``max_sweeps`` stops the loop."""
    # every edge lands in vertices [0, 64): window 1 (VB 64) owns nothing
    rng = np.random.default_rng(3)
    src = rng.integers(0, 128, 400)
    dst = rng.integers(0, 64, 400)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    n = 128
    g = from_coo(src, dst, n, edge_capacity=len(src) + 8)
    packed = pack_blocks(src, dst, np.ones(len(src), bool), n, be=32, vb=64)
    init = jnp.full((n,), 1.0 / n, jnp.float32)
    for sweeps in (1, 3):
        ref = j_gs(g, packed, init, tol=1e-7, max_sweeps=sweeps)
        out = gauss_seidel_pagerank(
            port_graph(g), port_packed(packed),
            torch.full((n,), 1.0 / n, dtype=torch.float32), tol=1e-7,
            max_sweeps=sweeps)
        assert out.sweeps == int(ref.sweeps) == sweeps
        np.testing.assert_allclose(out.ranks.numpy(), np.asarray(ref.ranks),
                                   rtol=0, atol=1e-6)
        assert np.all(out.ranks.numpy()[64:] == np.float32(1.0 / n))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """No module of the port imports ``jax`` or ``repro`` (at any depth:
    function-level imports included)."""
    bad = []
    for root, _, files in os.walk(SRC):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for name in _imports(path):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{os.path.relpath(path, SRC)}: {name}")
    assert bad == []
    assert os.path.exists(os.path.join(SRC, "core", "gauss_seidel.py"))
