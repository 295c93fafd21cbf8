"""A capacity-padded edge list, updated batch by batch, in plain torch.

Semantics (the configurations' ``graph`` section states them):

  * the graph is ``src``, ``dst`` (int32) and ``valid`` (bool) over a
    fixed number of slots; the initial live edges fill the first slots in
    ascending (src, dst) order, the rest are free;
  * a batch is a list of events in arrival order; for each (u, v) the last
    event wins (an insert after a delete of the same edge is an insert,
    and the reverse a delete);
  * deletions first: the slot holding a live (u, v) becomes free; a
    deletion of an absent edge does nothing;
  * then insertions, in order of each key's first event: one of a live
    edge, or a repeat of an earlier insertion of the batch, does nothing;
    the i-th remaining insertion takes the i-th free slot in slot order,
    and one that finds no free slot is dropped;
  * every vertex has an implicit self-loop, never stored.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class RefGraph:
    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor, num_vertices: int):
        self.src = src.clone()
        self.dst = dst.clone()
        self.valid = valid.clone()
        self.n = int(num_vertices)

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    def keys(self) -> torch.Tensor:
        return self.src.long() * self.n + self.dst.long()

    def num_live(self) -> int:
        return int(self.valid.sum())

    def apply(self, kinds: Sequence[int], us: np.ndarray,
              vs: np.ndarray) -> None:
        """Apply one batch of events: ``kinds[i]`` is 1 for an insertion
        and 0 for a deletion of (``us[i]``, ``vs[i]``), in arrival order."""
        kinds = np.asarray(kinds, np.int64)
        key = np.asarray(us, np.int64) * self.n + np.asarray(vs, np.int64)
        # last event per key wins; the key keeps the place of its first
        _, first = np.unique(key, return_index=True)
        _, last_rev = np.unique(key[::-1], return_index=True)
        last = len(key) - 1 - last_rev
        order = np.argsort(first, kind="stable")
        net_key = key[np.sort(first)]
        net_kind = kinds[last[order]]
        dev = self.src.device
        dels = torch.from_numpy(net_key[net_kind == 0]).to(dev)
        ins = torch.from_numpy(net_key[net_kind == 1]).to(dev)
        live_key = torch.where(self.valid, self.keys(),
                               torch.full_like(self.src, -1, dtype=torch.int64))
        if dels.numel():
            hit = torch.isin(live_key, dels) & self.valid
            self.valid = self.valid & ~hit
            live_key = torch.where(hit, -1, live_key)
        if ins.numel():
            ins = ins[~torch.isin(ins, live_key)]
            # repeats of an earlier insertion of the batch
            ins_np = ins.cpu().numpy()
            _, first_ins = np.unique(ins_np, return_index=True)
            ins = torch.from_numpy(ins_np[np.sort(first_ins)]).to(dev)
            free = torch.nonzero(~self.valid).squeeze(1)[: ins.shape[0]]
            ins = ins[: free.shape[0]]
            self.src = self.src.clone()
            self.dst = self.dst.clone()
            self.src[free] = (ins // self.n).to(torch.int32)
            self.dst[free] = (ins % self.n).to(torch.int32)
            self.valid = self.valid.clone()
            self.valid[free] = True

    def out_degree(self) -> torch.Tensor:
        """int64[V] live out-edges a vertex (the self-loop not counted)."""
        return torch.bincount(self.src[self.valid].long(),
                              minlength=self.n)

    def csr(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(indptr int64[V+1], indices int64[live], deg int64[V]): each
        vertex's live out-neighbours in slot order."""
        slots = torch.nonzero(self.valid).squeeze(1)
        s = self.src[slots].long()
        order = torch.argsort(s, stable=True)
        indices = self.dst[slots[order]].long()
        deg = torch.bincount(s, minlength=self.n)
        indptr = torch.zeros(self.n + 1, dtype=torch.int64,
                             device=s.device)
        indptr[1:] = torch.cumsum(deg, 0)
        return indptr, indices, deg
