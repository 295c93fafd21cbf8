"""NumPy arrays → the port's structures.

The rank service has no weights; its state is the graph, the packed
structure, the update batch, the ranks and the PPR walk index.  The GNN
refresh adds GraphSAGE parameters, and training every GNN's, LM's and
DeepFM's parameters and an AdamW state (``gnn_params_from_numpy``,
``lm_params_from_numpy``, ``deepfm_params_from_numpy``,
``adamw_state_from_numpy``; ``*_to_numpy`` hand
them back, so the two packages can be compared after k steps).  bf16
leaves travel as their 16-bit words (``ml_dtypes``' bfloat16 in, 2-byte
``V2`` words out, as a bf16 checkpoint leaf reads back), not through
``ml_dtypes``.  These functions build each of them from
plain NumPy arrays and ints (for example arrays read out of the JAX
package with ``np.asarray``), so two implementations can be handed the
same state.  Arrays are copied to ``device`` with their dtypes fixed to
the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.checkpoint import flatten_up_to, host_array, \
    tensor_from_host
from repro_torch.graph.dynamic import BatchUpdate
from repro_torch.graph.structure import CSRView, EdgeListGraph
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph
from repro_torch.models import transformer as T
from repro_torch.models.gnn import SAGE
from repro_torch.models.moe import MoEParams
from repro_torch.models.recsys import DeepFMParams
from repro_torch.models.tree import ParamTree, trainable, tree_map
from repro_torch.optim.adamw import AdamWState
from repro_torch.ppr.walks import WalkIndex


def _t(a, dtype, device) -> torch.Tensor:
    # a copy: the source may be a read-only view of another framework's
    # buffer, and the port owns its tensors
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def edge_list_from_numpy(src, dst, valid, num_vertices: int,
                         num_edges: int, device: DeviceLike = None
                         ) -> EdgeListGraph:
    device = resolve_device(device)
    return EdgeListGraph(
        src=_t(src, np.int32, device), dst=_t(dst, np.int32, device),
        valid=_t(valid, bool, device), num_vertices=int(num_vertices),
        num_edges=torch.tensor(int(num_edges), dtype=torch.int32,
                               device=device))


def packed_from_numpy(src, dst_rel, valid, window, entry_start, sorted_key,
                      sorted_lane, ovl_key, ovl_lane, *, num_vertices: int,
                      vb: int, be: int, max_entries_per_window: int,
                      device: DeviceLike = None) -> PackedGraph:
    """All nine leaves plus the static fields of a ``PackedGraph``."""
    device = resolve_device(device)
    return PackedGraph(
        src=_t(src, np.int32, device), dst_rel=_t(dst_rel, np.int32, device),
        valid=_t(valid, np.float32, device),
        window=_t(window, np.int32, device),
        entry_start=_t(entry_start, np.int32, device),
        sorted_key=_t(sorted_key, np.int64, device),
        sorted_lane=_t(sorted_lane, np.int32, device),
        ovl_key=_t(ovl_key, np.int64, device),
        ovl_lane=_t(ovl_lane, np.int32, device),
        num_vertices=int(num_vertices), vb=int(vb), be=int(be),
        max_entries_per_window=int(max_entries_per_window))


def batch_update_from_numpy(del_src, del_dst, del_mask, ins_src, ins_dst,
                            ins_mask, device: DeviceLike = None
                            ) -> BatchUpdate:
    device = resolve_device(device)
    return BatchUpdate(
        del_src=_t(del_src, np.int32, device),
        del_dst=_t(del_dst, np.int32, device),
        del_mask=_t(del_mask, bool, device),
        ins_src=_t(ins_src, np.int32, device),
        ins_dst=_t(ins_dst, np.int32, device),
        ins_mask=_t(ins_mask, bool, device))


def ranks_from_numpy(ranks, device: DeviceLike = None) -> torch.Tensor:
    """f64[V] ranks."""
    return _t(ranks, np.float64, resolve_device(device))


def walk_index_from_numpy(steps, indptr, indices, deg, key, num_walks: int,
                          max_len: int, alpha: float,
                          device: DeviceLike = None) -> WalkIndex:
    """A ``WalkIndex`` from its steps ``[V, R, L]``, its CSR and its base
    PRNG key (two uint32 words, as ``jax.random.PRNGKey`` holds them)."""
    device = resolve_device(device)
    k = np.asarray(key, np.uint32).reshape(2)
    return WalkIndex(
        steps=_t(steps, np.int32, device),
        csr=CSRView(indptr=_t(indptr, np.int32, device),
                    indices=_t(indices, np.int32, device),
                    deg=_t(deg, np.int32, device)),
        key=(int(k[0]), int(k[1])), num_walks=int(num_walks),
        max_len=int(max_len), alpha=float(alpha))


def sage_params_from_numpy(params, device: DeviceLike = None) -> SAGE:
    """GraphSAGE parameters from the reference's ``init_sage`` pytree: one
    ``dict(w_self=(w, b), w_neigh=(w, b))`` of arrays per layer."""
    device = resolve_device(device)
    return SAGE([{k: tuple(_t(a, np.float32, device) for a in lp[k])
                  for k in ("w_self", "w_neigh")} for lp in params])


def gnn_params_from_numpy(arch_id: str, params,
                          device: DeviceLike = None) -> ParamTree:
    """A GNN's parameters from the reference's ``init_*`` pytree of
    arrays (dicts, lists and tuples as the reference nests them), each
    leaf f32 (the reference draws NequIP's ``embed`` and ``mix_v`` in its
    default float, f64 under x64; the port trains in f32)."""
    device = resolve_device(device)
    if arch_id == "graphsage-reddit":
        return sage_params_from_numpy(params, device)
    return ParamTree(tree_map(lambda a: _t(a, np.float32, device), params))


def gnn_params_to_numpy(params: ParamTree):
    """A GNN's parameters as the reference nests them, each leaf a host
    NumPy copy."""
    return tree_map(lambda p: p.detach().cpu().numpy(), params.tree)


def adamw_state_from_numpy(params, step, m, v,
                           device: DeviceLike = None) -> AdamWState:
    """An ``AdamWState`` from the reference's (``step``, ``m``, ``v``)
    pytrees of arrays, with ``params`` the reference's parameter pytree
    (its structure pairs the leaves): lists in flatten order, each moment
    keeping its dtype."""
    device = resolve_device(device)

    def put(a):
        return tensor_from_host(a).to(device)

    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=[put(a) for a in flatten_up_to(params, m)],
        v=[tuple(put(x) for x in a) if isinstance(a, tuple) else put(a)
           for a in flatten_up_to(params, v)])


def adamw_state_to_numpy(state: AdamWState):
    """(step, m, v) of a state as host NumPy: lists in flatten order (bf16
    moments as 2-byte words)."""
    return (int(state.step), [host_array(t) for t in state.m],
            [tuple(host_array(x) for x in t) if isinstance(t, tuple)
             else host_array(t) for t in state.v])


def lm_params_from_numpy(params, device: DeviceLike = None) -> T.LMParams:
    """An LM's parameters from the reference's ``init_lm`` pytree of
    arrays (its ``LMParams`` / ``LayerParams`` / ``MoEParams``, read by
    field name), each leaf keeping its dtype, trainable."""
    device = resolve_device(device)

    def put(a):
        return tensor_from_host(a).to(device)

    def fields(cls, obj):
        return cls(*(put(getattr(obj, f)) for f in cls._fields))

    src = params.layers
    moe = None if src.moe is None else fields(MoEParams, src.moe)
    layers = T.LayerParams(*(put(getattr(src, f))
                             for f in T.LayerParams._fields[:-1]), moe=moe)
    return T.trainable(T.LMParams(embed=put(params.embed), layers=layers,
                                  ln_f=put(params.ln_f)))


def lm_params_to_numpy(params: T.LMParams) -> T.LMParams:
    """An LM's parameters as host NumPy in the port's ``LMParams`` nesting
    (the reference's fields and order); bf16 leaves as 2-byte words."""
    return tree_map(host_array, params)


def deepfm_params_from_numpy(params, device: DeviceLike = None
                             ) -> DeepFMParams:
    """DeepFM's parameters from the reference's ``init_deepfm`` pytree of
    arrays (its ``DeepFMParams``, read by field name), each leaf f32,
    trainable."""
    device = resolve_device(device)

    def put(a):
        return _t(a, np.float32, device)

    return trainable(DeepFMParams(
        table=put(params.table), table_w=put(params.table_w),
        mlp_ws=tuple(put(w) for w in params.mlp_ws),
        mlp_bs=tuple(put(b) for b in params.mlp_bs),
        bias=put(params.bias)))


def deepfm_params_to_numpy(params: DeepFMParams) -> DeepFMParams:
    """DeepFM's parameters as host NumPy in the reference's nesting."""
    return tree_map(host_array, params)
