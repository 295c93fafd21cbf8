"""DeepFM [arXiv:1703.04247]: sparse embeddings, FM and a deep MLP (twin of
``repro.models.recsys``).

The per-field tables are one ``[total_rows, dim]`` tensor with a row
offset a field, as in the reference.  Every gather from a table is
``models.message.edge_gather``: a gather forward, and a backward that sums
the slots' gradient rows by row id through ``pull_rows`` over the ids'
slot order (cached with the id tensor), so the dense table gradient adds
in a fixed order and a train step is the same bit for bit from run to run
on the card.  ``deepfm_forward`` gathers ``table`` and ``table_w`` with
one flattened id tensor, so the two backwards share one slot order.
``embedding_bag`` (the reference's gather plus ``segment_sum`` /
``segment_max``) sums through ``message.seg_sum`` / ``seg_max``.  The
MLP's products are ``torch.matmul`` in f32 (the reference leaves them to
XLA); callers on the card keep TF32 off.

Shapes served:
  * train_batch / serve_p99 / serve_bulk: pointwise scoring, batch B;
  * retrieval_cand: one query against 10^6 candidate item rows, one
    batched product (no loop).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.message import edge_gather, seg_max, seg_sum
from repro_torch.models.tree import init_device, randn, trainable

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 100_000
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    n_dense: int = 0

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def param_count(self) -> int:
        n = self.total_rows * (self.embed_dim + 1)
        d_in = self.n_sparse * self.embed_dim + self.n_dense
        dims = (d_in,) + self.mlp_dims + (1,)
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


class DeepFMParams(NamedTuple):
    table: torch.Tensor       # [total_rows, embed_dim]  factor embeddings
    table_w: torch.Tensor     # [total_rows, 1]          first-order weights
    mlp_ws: Tuple[torch.Tensor, ...]
    mlp_bs: Tuple[torch.Tensor, ...]
    bias: torch.Tensor


def init_deepfm(cfg: DeepFMConfig, generator: torch.Generator,
                device=None) -> DeepFMParams:
    """Random parameters by the reference's scheme (tables normal · 0.01,
    MLP weights normal · fan_in^-1/2, zero biases), drawn from
    ``generator`` on its device (another stream than ``jax.random``: carry
    the reference's own with ``convert.deepfm_params_from_numpy``); on a
    ``meta`` ``device`` nothing is drawn."""
    dev = init_device(generator, device)
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    dims = (d_in,) + cfg.mlp_dims + (1,)

    def normal(shape, scale):
        return randn(shape, generator, dev).mul_(scale)
    table = normal((cfg.total_rows, cfg.embed_dim), 0.01)
    table_w = normal((cfg.total_rows, 1), 0.01)
    ws = tuple(normal((a, b), a ** -0.5) for a, b in zip(dims[:-1], dims[1:]))
    bs = tuple(torch.zeros((b,), dtype=F32, device=dev) for b in dims[1:])
    return trainable(DeepFMParams(
        table=table, table_w=table_w, mlp_ws=ws, mlp_bs=bs,
        bias=torch.zeros((), dtype=F32, device=dev)))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bags: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function as the reference computes it:
    a gather, then a segment sum (``sum``, ``mean``) or max (``max``).

    ids: int32[NNZ] row ids; bags: int32[NNZ] bag of each id (sorted or
    not); returns [n_bags, dim].  An empty bag is 0 under ``sum`` and
    ``mean``, -inf under ``max`` (``jax.ops.segment_max``)."""
    rows = edge_gather(table, ids.to(torch.int32))
    if weights is not None:
        rows = rows * weights[:, None]
    bags = bags.to(torch.int32)
    if mode == "max":
        return seg_max(rows, bags, n_bags)
    out = seg_sum(rows, bags, n_bags)
    if mode == "mean":
        ones = torch.ones((ids.shape[0], 1), dtype=F32, device=ids.device)
        cnt = seg_sum(ones, bags, n_bags)
        out = out / torch.clamp(cnt, min=1.0)
    return out


def _field_ids(cfg: DeepFMConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """[B, n_sparse] per-field local ids -> int32 global row ids."""
    offs = torch.arange(cfg.n_sparse, dtype=torch.int32,
                        device=sparse_ids.device) * cfg.vocab_per_field
    return sparse_ids.to(torch.int32) + offs[None, :]


def deepfm_forward(cfg: DeepFMConfig, params: DeepFMParams,
                   sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids: int32[B, n_sparse] -> logits f32[B]."""
    b = sparse_ids.shape[0]
    # one id tensor for both gathers: one slot order for both backwards
    rows = _field_ids(cfg, sparse_ids).reshape(-1)
    emb = edge_gather(params.table, rows).reshape(b, cfg.n_sparse,
                                                  cfg.embed_dim)
    w1 = edge_gather(params.table_w, rows).reshape(b, cfg.n_sparse)

    # FM second order: ½((Σv)² − Σv²)
    sum_v = torch.sum(emb, dim=1)                          # [B, K]
    sum_v2 = torch.sum(torch.square(emb), dim=1)           # [B, K]
    fm2 = 0.5 * torch.sum(torch.square(sum_v) - sum_v2, dim=-1)
    fm1 = torch.sum(w1, dim=1)

    # deep branch
    h = emb.reshape(b, cfg.n_sparse * cfg.embed_dim)
    last = len(params.mlp_ws) - 1
    for i, (w, bb) in enumerate(zip(params.mlp_ws, params.mlp_bs)):
        h = torch.matmul(h, w) + bb
        if i < last:
            h = torch.relu(h)
    return params.bias + fm1 + fm2 + h[:, 0]


def deepfm_loss(cfg: DeepFMConfig, params: DeepFMParams,
                sparse_ids: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """Mean binary cross-entropy on the logits, the reference's formula
    max(z, 0) − z·y + log1p(exp(−|z|))."""
    z = deepfm_forward(cfg, params, sparse_ids)
    return torch.mean(torch.clamp(z, min=0) - z * labels
                      + torch.log1p(torch.exp(-torch.abs(z))))


def retrieval_score(cfg: DeepFMConfig, params: DeepFMParams,
                    query_ids: torch.Tensor, cand_item_ids: torch.Tensor
                    ) -> torch.Tensor:
    """retrieval_cand: one query (its field ids) scored against
    ``n_candidates`` item rows, one batched product.

    query_ids: int32[1, n_sparse]; cand_item_ids: int32[NC] raw rows of
    the table (field 0's, with no field offset, as the reference reads
    them)."""
    rows = _field_ids(cfg, query_ids).reshape(-1)
    q = torch.sum(edge_gather(params.table, rows), dim=0)      # [K]
    cand = edge_gather(params.table, cand_item_ids.to(torch.int32))
    return torch.matmul(cand, q)                               # [NC]
