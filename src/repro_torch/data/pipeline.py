"""Deterministic synthetic data pipelines (no downloads).

Counterpart of ``repro/data/pipeline.py``, the port's own numpy copy: the
batches are the reference's byte for byte.  They are host numpy arrays;
the caller moves them to its device.

Token stream: a counter-based hash (splittable, restart-stable) -> any
(step, shard) batch is reproducible with no state, which is what makes the
fault-tolerance shard-reassignment sound: a host taking over shard k resumes
exactly where the dead host would have been.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-mul counter hash (splitmix-style), vectorized."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq: int
    global_batch: int
    n_shards: int = 1          # data-parallel host shards
    seed: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch(self, step: int, shard: int = 0) -> dict:
        """Host-shard slice of the global batch for ``step``.  tokens/labels
        are next-token shifted views of one stream."""
        b = self.shard_batch
        rows = np.arange(b, dtype=np.uint64) + shard * b
        base = (np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64(step) * np.uint64(1 << 20))
        counters = (base + rows[:, None] * np.uint64(self.seq + 1)
                    + np.arange(self.seq + 1, dtype=np.uint64)[None, :])
        toks = (_hash_u32(counters) % np.uint32(self.vocab)).astype(np.int32)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])

    def global_batch_at(self, step: int) -> dict:
        parts = [self.batch(step, s) for s in range(self.n_shards)]
        return {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}


@dataclass(frozen=True)
class EmbedsPipeline:
    """Stub-modality pipeline (VLM patches / audio frames): deterministic
    gaussian embeddings + next-'token' labels."""
    d_model: int
    seq: int
    global_batch: int
    vocab: int
    n_shards: int = 1
    seed: int = 0
    mrope: bool = False
    encoder_seq: int = 0      # >0 -> enc-dec batch

    def batch(self, step: int, shard: int = 0) -> dict:
        b = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step * 1009 + shard) & 0x7FFFFFFF)
        toks = rng.integers(0, self.vocab, (b, self.seq + 1)).astype(np.int32)
        out = dict(labels=toks[:, 1:])
        if self.encoder_seq:
            out["enc_embeds"] = rng.standard_normal(
                (b, self.encoder_seq, self.d_model)).astype(np.float32)
            out["tokens"] = toks[:, :-1]
        else:
            out["embeds"] = rng.standard_normal(
                (b, self.seq, self.d_model)).astype(np.float32)
            if self.mrope:
                base = np.arange(self.seq, dtype=np.int32)
                out["positions"] = np.broadcast_to(
                    base[None, None], (3, b, self.seq)).copy()
        return out


def pipeline_for(cfg, seq: int, global_batch: int, n_shards: int = 1,
                 seed: int = 0):
    if cfg.family == "encdec":
        return EmbedsPipeline(cfg.d_model, seq, global_batch, cfg.vocab,
                              n_shards, seed, encoder_seq=cfg.encoder_seq)
    if cfg.input_mode == "embeds":
        return EmbedsPipeline(cfg.d_model, seq, global_batch, cfg.vocab,
                              n_shards, seed, mrope=cfg.mrope_sections is not None)
    return TokenPipeline(cfg.vocab, seq, global_batch, n_shards, seed)
