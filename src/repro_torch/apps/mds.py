"""Multidimensional scaling — the paper's flagship composition (Figs 14/15).

Ports ``src/repro/apps/mds.py``, the HPTMT pattern end to end:

  1. *table operators* (dataflow style) curate the input point set —
     select by quality, order by id (:func:`curated_table`);
  2. the ``to_torch`` bridge (the reference's ``to_jax``) hands the
     curated table to array land (Fig 13 line 28 / Fig 17 line 18);
  3. *array operators* compute the row-partitioned distance matrix
     (AllGather of the point blocks — Table I; :func:`distance_matrix`)
     and run SMACOF iterations (:func:`smacof`) — the MPI side of Fig 14.

Same code runs on one shard, on ``n_shards`` virtual shards, or on a
process group, where each rank computes the δ row blocks of its own
shards, as the reference's ``shard_map`` block does, and δ is then
all-gathered so that SMACOF runs on the whole of it on every rank, as
the reference's runs outside its ``shard_map``.  The
arithmetic is the reference's: distances ``sqrt(max(|x|² + |y|² - 2x·y,
1e-12))``, δ and the ratio matrix masked on the diagonal, the Guttman
step ``b @ x / n``, the stress taken before the update.  At a card's size
(2^15 points: δ is 4.3 GB) the diagonal is set in place instead of
through an ``n x n`` boolean identity.  The random start comes from
:func:`initial_embedding`, a ``torch.Generator`` seeded with ``seed``: the
reference's ``jax.random.normal`` start cannot be reproduced here.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import HPTMTContext
from ..core.array_ops import spmd_allgather
from ..dataframe import DataFrame

#: the point table's feature columns
FEATURES = [f"f{i}" for i in range(4)]


def _pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(|x_i|² + |y_j|² - 2 x_i·y_j, 1e-12))``, the reference's
    order of operations, with one ``(rows(x), rows(y))`` temporary."""
    g = (2 * x) @ y.T
    d = (x * x).sum(1)[:, None] + (y * y).sum(1)[None]
    d.sub_(g)
    del g
    return d.clamp_(min=1e-12).sqrt_()


def initial_embedding(n: int, dim: int, seed: int,
                      device: torch.device) -> torch.Tensor:
    """SMACOF's random start: ``0.1 * N(0, 1)`` of shape ``(n, dim)`` from
    a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, dim), generator=gen, device=device) * 0.1


def guttman_step(delta: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SMACOF iteration on a diagonal-masked δ: ``(x_new, stress of
    x)``.

    The Guttman transform requires a strictly off-diagonal B matrix — the
    sqrt-clamp in the distance leaves ~1e-6 on the diagonal, which
    (δ_ii/d_ii = 1) silently breaks the majorization, so the ratio matrix
    and the stress terms are masked on the diagonal too."""
    n = delta.shape[0]
    d = _pairwise_dist(x, x)
    ratio = torch.where(d > 1e-9, delta / torch.clamp(d, min=1e-9), 0.0)
    ratio.fill_diagonal_(0.0)
    row_sums = ratio.sum(1)
    b = ratio.neg_()
    b.diagonal().copy_(row_sums)
    x_new = (b @ x) / n
    del b, ratio
    sq = d.sub_(delta).square_()  # (d - δ)² == (δ - d)², bit for bit
    sq.fill_diagonal_(0.0)
    return x_new, sq.sum() / 2


def smacof(delta: torch.Tensor, dim: int, iters: int, seed: int
           ) -> Tuple[List[float], torch.Tensor]:
    """Classic SMACOF on a full dissimilarity matrix (array operators):
    ``(path, x)``, ``path[i]`` the stress of the ``i``-th iterate and
    ``x`` the last update.  Runs eagerly on δ's device; the stresses are
    read back once, at the end."""
    n = delta.shape[0]
    delta = delta.clone(memory_format=torch.contiguous_format)
    delta.fill_diagonal_(0.0)
    x = initial_embedding(n, dim, seed, delta.device)
    stresses = []
    for _ in range(iters):
        x, stress = guttman_step(delta, x)
        stresses.append(stress)
    path = torch.stack(stresses).tolist() if stresses else []
    return path, x


def point_columns(n_points: int, seed: int) -> dict:
    """The reference's raw point table: ``n + n // 3 + 1`` rows of 4 normal
    features and a quality in [0, 1), clamped so that exactly ``n_points``
    rows have quality >= 0.5."""
    rng = np.random.default_rng(seed)
    n_raw = n_points + n_points // 3 + 1
    feats = rng.normal(size=(n_raw, 4)).astype(np.float32)
    quality = rng.uniform(size=n_raw).astype(np.float32)
    order = np.argsort(-quality)
    quality[order[:n_points]] = np.clip(quality[order[:n_points]], 0.5, None)
    quality[order[n_points:]] = np.clip(quality[order[n_points:]], None,
                                        0.49)
    return {"id": np.arange(n_raw, dtype=np.int32), "quality": quality,
            **{name: feats[:, i] for i, name in enumerate(FEATURES)}}


def curated_table(n_points: int, ctx: HPTMTContext, seed: int = 0
                  ) -> DataFrame:
    """Table operators: the raw point table, ``select`` by quality, then
    ``sort_values`` by id (a deterministic row order; one range exchange
    on more than one shard).

    The ids arrive sorted, so each shard sends all its rows to one
    destination: the sort's send buckets hold a whole shard
    (``bucket_factor=n_shards``).  The reference keeps the default of 2,
    and its 4-shard pipeline overflows there (ROADMAP Queue 3)."""
    df = DataFrame.from_dict(point_columns(n_points, seed), ctx)
    return df.select(lambda c: c["quality"] >= 0.5).sort_values(
        "id", bucket_factor=float(ctx.n_shards))


def distance_matrix(points: torch.Tensor, ctx: HPTMTContext
                    ) -> torch.Tensor:
    """δ, row-partitioned: on ``n_shards > 1`` the points are padded with
    zero rows to a multiple of the shard count, each shard computes the
    distances from its block to the all-gather of every block, and the
    row blocks are stacked and cut to ``(n, n)``.  On a group ``points``
    is the whole point set on every rank; each rank computes its shards'
    row blocks and the blocks are all-gathered, so every rank returns the
    whole δ."""
    n, p = points.shape[0], ctx.n_shards
    if p == 1:
        return _pairwise_dist(points, points)
    pts = F.pad(points, (0, 0, 0, (-n) % p))
    mine = list(pts.tensor_split(p))[ctx.local_shards.start:
                                     ctx.local_shards.stop]
    everyone = spmd_allgather(mine, group=ctx.group)
    rows = [_pairwise_dist(m, all_pts) for m, all_pts in zip(mine, everyone)]
    delta = spmd_allgather(rows, group=ctx.group)[0]
    return delta[:n, :n]


def mds_pipeline(n_points: int, dim: int, iters: int, ctx: HPTMTContext,
                 seed: int = 0) -> Tuple[List[float], torch.Tensor]:
    """Fig 14 end-to-end: table preprocessing → distance matrix → MDS."""
    points = curated_table(n_points, ctx, seed).to_torch(FEATURES)
    if points.shape[0] != n_points:
        raise RuntimeError(f"the table side kept {points.shape[0]} points, "
                           f"expected {n_points}")
    return smacof(distance_matrix(points, ctx), dim, iters, seed)
