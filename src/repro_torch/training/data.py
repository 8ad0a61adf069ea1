"""Synthetic LM data pipeline (copy of ``repro.training.data``; numpy
only, so its batches equal the reference's bit for bit).

Deterministic, seekable token streams: batch ``i`` is a pure function of
(seed, i), so a restarted job resumes mid-epoch with no state beyond the
step counter — the data-side half of fault-tolerant training. Per-host
sharding takes disjoint slices of the global batch by process index.

The generator synthesizes structured sequences (repeated n-gram motifs over
a Zipfian vocabulary) rather than iid noise so a ~100M model shows a real
learning curve in examples/port_train_small.py.

:class:`EmbeddingsFrontend` is the port's own: it makes the inputs of the
configs whose model takes embeddings (qwen2-vl, musicgen) from the token
stream, which the reference's launcher does not (it trains neither).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 512
    zipf_a: float = 1.2


class SyntheticLM:
    """Seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # fixed motif table (the "knowledge" the model can learn)
        self.motifs = root.integers(
            2, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int64
        )

    def batch(self, index: int, *, process_index: int = 0, process_count: int = 1):
        """Batch `index`, host shard `process_index` of `process_count`.

        Returns dict(tokens (b_local, L) int32, labels shifted by one).
        """
        cfg = self.cfg
        if cfg.global_batch % process_count:
            raise ValueError("global batch must divide process count")
        b_local = cfg.global_batch // process_count
        rng = np.random.default_rng(
            (cfg.seed, index, process_index, 0xD1E5EED)
        )
        n_slots = cfg.seq_len // cfg.motif_len + 1
        motif_ids = rng.zipf(cfg.zipf_a, size=(b_local, n_slots))
        motif_ids = np.minimum(motif_ids - 1, cfg.n_motifs - 1)
        seq = self.motifs[motif_ids].reshape(b_local, -1)[:, : cfg.seq_len + 1]
        # sprinkle noise tokens so the task isn't trivially memorizable
        noise_mask = rng.random(seq.shape) < 0.05
        noise = rng.integers(2, cfg.vocab, size=seq.shape)
        seq = np.where(noise_mask, noise, seq)
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


class EmbeddingsFrontend:
    """The embeddings frontend's inputs from a token batch: each token's row
    of a fixed seeded table of std 0.1 (``rows`` rows, the token id modulo
    that, values rounded to bfloat16's 8 significant bits), M-RoPE's
    positions (each position's index on all three streams), a conditioning
    memory of std 0.1 seeded by the batch index, and the labels, one column
    a codebook (codebook k's: the next token plus k, modulo the
    vocabulary). Arrays are float32 and int32; the caller casts them to the
    model's input dtypes."""

    rows = 4096

    def __init__(self, cfg: ArchConfig, seed: int = 0) -> None:
        self.cfg, self.seed = cfg, seed
        rng = np.random.default_rng((seed, 0xE3BED5))
        self.table = _bf16_values(rng.normal(size=(min(cfg.vocab, self.rows), cfg.d_model)) * 0.1)

    def __call__(self, batch: dict, index: int) -> dict:
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        b, length = tokens.shape
        out = {"embeds": self.table[tokens % len(self.table)]}
        if cfg.pos_type == "mrope":
            out["positions"] = np.broadcast_to(np.arange(length, dtype=np.int32),
                                               (3, b, length)).copy()
        if cfg.cross_attention:
            rng = np.random.default_rng((self.seed, index, 0xC0DE))
            out["memory"] = _bf16_values(rng.normal(size=(b, cfg.cross_mem_len, cfg.d_model)) * 0.1)
        if cfg.n_codebooks:
            shift = np.arange(cfg.n_codebooks, dtype=np.int64)
            labels = ((labels[..., None].astype(np.int64) + shift) % cfg.vocab).astype(np.int32)
        out["labels"] = labels
        return out


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float32."""
    bits = x.astype(np.float32).view(np.uint32)
    bits = bits + 0x7FFF + ((bits >> 16) & 1)
    return (bits & 0xFFFF0000).view(np.float32)


def make_batch_fn(cfg: ArchConfig, seq_len: int, global_batch: int, seed: int = 0):
    """Batch ``index`` → the model's inputs: tokens and labels, or for the
    embeddings frontend :class:`EmbeddingsFrontend`'s inputs from them."""
    data = SyntheticLM(
        DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed
        )
    )
    if cfg.frontend == "tokens":
        return data.batch
    frontend = EmbeddingsFrontend(cfg, seed)
    return lambda index, **kw: frontend(data.batch(index, **kw), index)
