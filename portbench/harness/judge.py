"""Judge what the window produced against the plain reference.

The reference replays the same initial graph and the same feed, batch by
batch, from nothing the program made, and works out:

  * ``edge_slots_differing``: slots whose (valid, src, dst) differ
    between the program's last published graph and the reference's after
    the same batches (the graph update; exact, limit 0);
  * ``rank_l1``: the L1 distance between the last published ranks and a
    static f64 PageRank of the reference's graph (the DF-P solve), with
    readings beside it: ``rank_linf`` the largest gap, ``rank_rel_max``
    and ``rank_rel_mean`` the largest and mean gap as a share of the
    vertex's rank, ``rank_top_rel_max`` and ``rank_top_l1`` the same over
    the 1 % of vertices of highest rank;
  * ``walk_steps_differing``: entries of the last published walk index
    that differ from a fresh sampling of every walk on the reference's
    graph (the walk repair; exact, limit 0);
  * ``answer_gap``: over a sample of the window's answered queries,
    drawn from the seed (always with the one whose vertex had the most
    out-edges), the largest gap, as a share of the query's largest
    estimate, between a returned value and the reference's estimate of
    that vertex at the generation the query was served from, or between
    the reference's k-th value and the least reference value of the
    returned vertices (so ties may go either way, but a vertex below the
    true top k may not).

``control="reference_f32"`` puts the reference itself, computed in
float32, in the program's place for the ranks and the answers.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import graph as ref_graph
from reference import pagerank as ref_pagerank
from reference import ppr as ref_ppr
from reference import walks as ref_walks

SAMPLED_ANSWERS = 48
WALK_CHUNK = 1 << 22           # walks compared together


def _sample(answers: list, seed: int, deg0: np.ndarray) -> list:
    if not answers:
        return []
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = set(rng.choice(len(answers), min(SAMPLED_ANSWERS, len(answers)),
                          replace=False).tolist())
    pick.add(int(np.argmax([deg0[a["vertex"]] for a in answers])))
    return sorted((answers[i] for i in pick),
                  key=lambda a: a["answer"].generation)


def _answer_gap(est: torch.Tensor, vertices: list, values: list,
                k: int) -> float:
    top = float(est.max())
    ref_at = est[torch.as_tensor(vertices, device=est.device)].double()
    got = torch.as_tensor(values, dtype=torch.float64, device=est.device)
    kth = float(torch.topk(est.double(), k).values[-1])
    gap = max(float((got - ref_at).abs().max()), kth - float(ref_at.min()),
              0.0)
    if len(set(vertices)) != len(vertices) or len(vertices) != k:
        return float("inf")
    return gap / top if top > 0 else float("inf")


def judge(config: dict, mix: dict, graph0, feed, result: dict,
          outputs: dict, seed: int, device, control: str = "") -> dict:
    """The compared numbers, by name."""
    n = graph0.num_vertices
    ref = ref_graph.RefGraph(graph0.src.to(device), graph0.dst.to(device),
                             graph0.valid.to(device), n)
    deg0 = ref.out_degree().cpu().numpy()
    ppr = config.get("ppr_index")
    k = int((mix.get("queries") or {}).get("k", 10))
    sampled = _sample(result["answers"], seed, deg0) if ppr else []
    kinds = feed.kinds()
    gaps = []
    q = 0
    f32 = control == "reference_f32"
    for b in range(result["applied"]):
        us, vs = feed.pairs(b)
        ref.apply(kinds, us, vs)
        gen = b + 1
        if q < len(sampled) and sampled[q]["answer"].generation == gen:
            csr = ref.csr()
            while q < len(sampled) and \
                    sampled[q]["answer"].generation == gen:
                a = sampled[q]
                est = ref_ppr.estimate(
                    *csr, a["vertex"], num_walks=int(ppr["num_walks"]),
                    max_len=int(ppr["max_len"]), alpha=float(ppr["alpha"]),
                    key_seed=seed)
                if f32:
                    e32 = ref_ppr.estimate(
                        *csr, a["vertex"], num_walks=int(ppr["num_walks"]),
                        max_len=int(ppr["max_len"]),
                        alpha=float(ppr["alpha"]), key_seed=seed,
                        dtype=torch.float32)
                    vals, idx = torch.topk(e32, k)
                    gaps.append(_answer_gap(est, idx.tolist(),
                                            vals.double().tolist(), k))
                else:
                    gaps.append(_answer_gap(est, a["answer"].vertices,
                                            a["answer"].values, k))
                q += 1
    out = {}
    p_valid = outputs["valid"].to(device)
    diff = (p_valid != ref.valid) | (ref.valid & (
        (outputs["src"].to(device) != ref.src)
        | (outputs["dst"].to(device) != ref.dst)))
    out["edge_slots_differing"] = int(diff.sum())
    if outputs["generation"] != result["applied"]:
        out["edge_slots_differing"] = max(out["edge_slots_differing"], 1)
    alpha = float(config["solver"]["alpha"])
    truth = ref_pagerank.pagerank(ref.src, ref.dst, ref.valid, n,
                                  alpha=alpha)
    if f32:
        ranks = ref_pagerank.pagerank(ref.src, ref.dst, ref.valid, n,
                                      alpha=alpha, dtype=torch.float32)
    else:
        ranks = outputs["ranks"].to(device)
    err = (ranks.double() - truth).abs()
    out["rank_l1"] = float(err.sum())
    out["rank_linf"] = float(err.max())
    rel = err / truth
    top = torch.topk(truth, max(1, n // 100)).indices
    out["rank_rel_max"] = float(rel.max())
    out["rank_rel_mean"] = float(rel.mean())
    out["rank_top_rel_max"] = float(rel[top].max())
    out["rank_top_l1"] = float(err[top].sum())
    if ppr:
        steps = outputs["walks"]
        R, L = int(ppr["num_walks"]), int(ppr["max_len"])
        indptr, indices, deg = ref.csr()
        bad = 0
        rows = max(1, WALK_CHUNK // R)
        for v0 in range(0, n, rows):
            src = torch.arange(v0, min(n, v0 + rows), device=device)
            w = ref_walks.walks(indptr, indices, deg, src, R, L,
                                float(ppr["alpha"]), seed)
            bad += int((w != steps[v0:v0 + rows].to(device)).sum())
        out["walk_steps_differing"] = bad
        out["answer_gap"] = max(gaps) if gaps else float("inf")
        out["answers_compared"] = len(gaps)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers the cell's
    limits name; the others are readings, not compared.  A limit whose
    number the run did not produce is a failure."""
    rows = [(name, numbers.get(name, float("inf")), limits[name])
            for name in limits]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows
