"""Data pipeline: HPTMT table operators feeding tensor training.

Ports ``src/repro/data/pipeline.py``, the paper's flagship composition
(Fig 14): dataflow table operators pre-process a corpus, then hand off to
tensor operators for the numeric algorithm.  The synthetic corpus is a
pair of tables — documents (doc_id, quality, n_tokens) and token rows
(doc_id, position, token) — and the pipeline is

    select(quality ≥ θ) → join(tokens ⋈ docs) → orderby
        → to_numpy() → fixed-length (tokens, labels) batches,

the table→tensor bridge of paper Figs 13/17.  The tables live on
``ctx.device`` (the card unless the context names the CPU); the curated
stream comes back to the host, and the batches go to the device as
int32 tensors.

On a process group (``ctx.group``: the data axis of a training mesh)
each rank builds — or, from a disk corpus, scans — and curates its own
shards, and the ordered stream is
gathered to every rank, bit for bit the virtual run's on as many shards
(the reference's drop quirk included: it depends on the shard count).
Every rank then draws the same global batches from the seed; a sharded
train step takes its rows of each (``train.train_step.local_batch``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import DistTable, HPTMTContext, Table, table_ops
from ..core.context import DeviceLike, resolve_device
from ..core.dataflow import TSet


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 64
    mean_doc_len: int = 96
    vocab_size: int = 128
    quality_threshold: float = 0.3
    seed: int = 0


def synthetic_corpus_arrays(ccfg: CorpusConfig
                            ) -> Dict[str, Dict[str, np.ndarray]]:
    """Pure-numpy corpus generation: ``{"docs": cols, "tokens": cols}``,
    the reference's numbers from the same seed."""
    rng = np.random.default_rng(ccfg.seed)
    lens = np.clip(rng.poisson(ccfg.mean_doc_len, ccfg.n_docs), 8, None)
    quality = rng.uniform(size=ccfg.n_docs).astype(np.float32)
    doc_ids = np.repeat(np.arange(ccfg.n_docs), lens).astype(np.int32)
    positions = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    # token stream with mild structure so small models can learn it
    toks = ((doc_ids * 31 + positions * 7) % (ccfg.vocab_size - 2) + 1
            ).astype(np.int32)
    return {
        "docs": {"doc_id": np.arange(ccfg.n_docs, dtype=np.int32),
                 "quality": quality,
                 "n_tokens": lens.astype(np.int32)},
        "tokens": {"doc_id": doc_ids, "position": positions, "token": toks},
    }


def synthetic_corpus(ccfg: CorpusConfig, ctx: HPTMTContext
                     ) -> Dict[str, DistTable]:
    """Two-table corpus: docs metadata + flat token rows."""
    arrays = synthetic_corpus_arrays(ccfg)
    docs = Table.from_arrays(arrays["docs"], device=ctx.device)
    tokens = Table.from_arrays(arrays["tokens"], device=ctx.device)
    total = arrays["tokens"]["doc_id"].shape[0]
    p = ctx.n_shards
    return {
        "docs": DistTable.from_local(docs, ctx,
                                     capacity=-(-ccfg.n_docs // p)),
        "tokens": DistTable.from_local(tokens, ctx, capacity=-(-total // p)),
    }


def disk_corpus(root: str, ctx: HPTMTContext,
                quality_threshold: Optional[float] = None,
                ) -> Dict[str, DistTable]:
    """Scan a corpus written as on-disk datasets (``root/docs``,
    ``root/tokens``) back into distributed tables.  With a
    ``quality_threshold`` the docs scan skips whole fragments whose
    quality max falls below it, before any rows materialize."""
    from ..io import pred, read_dataset

    doc_pred = (pred("quality", ">=", float(quality_threshold))
                if quality_threshold is not None else None)
    docs, ov_d, _ = read_dataset(os.path.join(root, "docs"), ctx=ctx,
                                 predicate=doc_pred)
    tokens, ov_t, _ = read_dataset(os.path.join(root, "tokens"), ctx=ctx)
    if ov_d or ov_t:
        raise RuntimeError(f"corpus scan overflowed ({int(ov_d + ov_t)} "
                           f"rows) — raise the scan capacity")
    return {"docs": docs, "tokens": tokens}


def preprocess(corpus: Dict[str, DistTable], ccfg: CorpusConfig,
               ctx: HPTMTContext) -> np.ndarray:
    """Dataflow pipeline → flat curated token stream (host array)."""
    docs = TSet.from_table(corpus["docs"], ctx)
    tokens = TSet.from_table(corpus["tokens"], ctx,
                             chunk_rows=max(corpus["tokens"].capacity // 4, 8))
    good = docs.select(lambda c: c["quality"] >= ccfg.quality_threshold) \
               .project(["doc_id", "quality"])
    curated = tokens.join(good, keys=["doc_id"],
                          out_capacity=corpus["tokens"].capacity)
    result = curated.collect()
    # global order by (doc, position) → deterministic stream
    ordered, _ = table_ops.orderby(result, "doc_id", ctx=ctx)
    arrs = ordered.to_numpy()
    order = np.lexsort((arrs["position"], arrs["doc_id"]))
    return arrs["token"][order]


def batch_iterator(stream: np.ndarray, batch: int, seq_len: int,
                   seed: int = 0, device: DeviceLike = None,
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite (tokens, labels) int32 batches on ``device`` (the card
    unless the caller names another) from a curated token stream."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(stream) - (seq_len + 1)
    if n <= 0:
        reps = (seq_len + 2) // max(len(stream), 1) + 1
        stream = np.tile(stream, reps)
        n = len(stream) - (seq_len + 1)
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([stream[s:s + seq_len] for s in starts])
        labels = np.stack([stream[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev),
               "labels": torch.from_numpy(labels.astype(np.int32)).to(dev)}


class TrainingData:
    """The batch iterator :func:`make_training_data` returns; ``stream``
    is the curated token stream the batches are drawn from."""

    def __init__(self, stream: np.ndarray,
                 batches: Iterator[Dict[str, torch.Tensor]]):
        self.stream = stream
        self._batches = batches

    def __iter__(self) -> "TrainingData":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return next(self._batches)


def make_training_data(cfg: ModelConfig, ctx: HPTMTContext, batch: int,
                       seq_len: int, ccfg: Optional[CorpusConfig] = None,
                       data_root: Optional[str] = None) -> TrainingData:
    """Batches on ``ctx.device`` from the synthetic corpus, or — with
    ``data_root`` — from an on-disk dataset corpus through the storage
    scan.  Encoder-decoder and VLM configs get stub frontend embeddings,
    ``0.02 * normal`` float32, as the reference makes them."""
    ccfg = ccfg or CorpusConfig(vocab_size=cfg.vocab_size)
    corpus = (disk_corpus(data_root, ctx) if data_root is not None
              else synthetic_corpus(ccfg, ctx))
    stream = preprocess(corpus, ccfg, ctx)
    base = batch_iterator(stream, batch, seq_len, seed=ccfg.seed,
                          device=ctx.device)
    if cfg.frontend is None and not cfg.is_encoder_decoder:
        return TrainingData(stream, base)

    def with_frontend():
        rng = np.random.default_rng(ccfg.seed + 1)
        for b in base:
            fe = rng.normal(size=(batch, cfg.frontend_seq, cfg.d_model)
                            ).astype(np.float32) * 0.02
            yield {**b, "frontend": torch.from_numpy(fe).to(ctx.device)}

    return TrainingData(stream, with_frontend())
