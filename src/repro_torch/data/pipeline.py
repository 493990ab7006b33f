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


def image_positions(B: int, text: int, rows: int, cols: int,
                    after: int) -> np.ndarray:
    """Qwen2-VL's (3, B, S) int32 M-RoPE positions (temporal, height,
    width) for one image on every row: ``text`` tokens at t = h = w =
    0..text-1, a rows x cols patch grid at t = text, h = text + row, w =
    text + col, then ``after`` text tokens from the grid's largest
    position + 1 on."""
    t = np.arange(text)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    grid = (np.full(rows * cols, text), text + r.ravel(), text + c.ravel())
    tail = np.arange(after) + text + max(rows, cols)
    pos = np.stack([np.concatenate([t, g, tail]) for g in grid])
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).astype(
        np.int32).copy()


def stub_batch(cfg, B: int, S: int, seed: int,
               image: dict | None = None) -> dict:
    """One batch of a stub-modality model made from ``seed``: next-token
    labels (B, S) and, for an encoder-decoder model (Whisper),
    ``encoder_seq`` frames (B, Se, d) ~ N(0, 1) with decoder tokens (B, S);
    else embeddings (B, S, d) ~ N(0, 1) (Qwen2-VL's patches and text),
    with ``image`` (image_positions' keyword arguments, S tokens in all)
    giving its M-RoPE positions, or none (the text positions)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = dict(labels=toks[:, 1:])
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        out["tokens"] = toks[:, :-1]
        return out
    out["embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                        dtype=np.float32)
    if image is not None:
        out["positions"] = image_positions(B, **image)
        if out["positions"].shape[2] != S:
            raise ValueError(f"image layout {image} is not {S} tokens")
    return out
