"""Synthetic LM data pipeline (copy of ``repro.training.data``; numpy
only, so its batches equal the reference's bit for bit).

Deterministic, seekable token streams: batch ``i`` is a pure function of
(seed, i), so a restarted job resumes mid-epoch with no state beyond the
step counter — the data-side half of fault-tolerant training. Per-host
sharding takes disjoint slices of the global batch by process index.

The generator synthesizes structured sequences (repeated n-gram motifs over
a Zipfian vocabulary) rather than iid noise so a ~100M model shows a real
learning curve in examples/port_train_small.py.
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


def make_batch_fn(cfg: ArchConfig, seq_len: int, global_batch: int, seed: int = 0):
    data = SyntheticLM(
        DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed
        )
    )
    return data.batch
