#!/usr/bin/env python3
"""Block-Gauss-Seidel against Jacobi as the graph grows: sweeps,
iterations and L1 against a static f64 solve, on R-MAT graphs packed at
BE 512 / VB 256 (the serving pack's geometry), from 1/|V|.

    PYTHONPATH=src python tools/gs_convergence.py --tol 1e-7 \\
        --scales 12 14 16 18 --device cpu

One line a scale.  It shows how the stopping rule (L∞ change < tol)
leaves more L1 error as the ranks shrink with |V|.  Times on the CPU are
not device times.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.gauss_seidel import gauss_seidel_pagerank
from repro_torch.core.kernel_engine import kernel_pagerank_loop
from repro_torch.core.pagerank import static_pagerank
from repro_torch.device import resolve_device
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import pack_blocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--scales", type=int, nargs="+", default=[12, 14, 16])
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for scale in args.scales:
        edges, n = rmat_edges(scale, args.edge_factor, seed=0)
        g = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        p = pack_blocks(edges[:, 0], edges[:, 1], np.ones(len(edges), bool),
                        n, be=512, vb=256, device=dev)
        init = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        gs = gauss_seidel_pagerank(g, p, init, tol=args.tol)
        gs_s = time.perf_counter() - t0
        jac = kernel_pagerank_loop(g, p, init,
                                   torch.ones(n, dtype=torch.bool,
                                              device=dev),
                                   tol=args.tol, closed_form=True,
                                   expand=False)
        ref = static_pagerank(g).ranks
        l1 = float((gs.ranks.double() - ref).abs().sum())
        l1_jac = float((jac.ranks.double() - ref).abs().sum())
        print(f"scale {scale} |V| {n} windows {p.num_windows} tol "
              f"{args.tol:g}: Gauss-Seidel {gs.sweeps} sweeps, L1 {l1:.3e}; "
              f"Jacobi {jac.iterations} iterations, L1 {l1_jac:.3e}; "
              f"{gs_s / gs.sweeps * 1e3:.1f} ms a sweep on {dev.type}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
