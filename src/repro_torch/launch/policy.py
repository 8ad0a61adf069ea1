"""Per-(architecture × shape-cell × mesh) sharding policy (counterpart of
``repro.launch.policy``: the same decisions, read from the port's configs
and a DeviceMesh's axis sizes).

Placements must divide tensor dims evenly (:class:`~repro_torch.distributed.
sharding.Layout` refuses any other), so each logical axis is
mapped to a mesh axis only when the corresponding model dimension divides
the mesh axis size; otherwise it degrades to replication (or, for KV
caches, to sequence sharding). The decisions:

* ``heads`` / ``kv_heads`` / ``ssm_heads`` / ``experts`` → "model" iff
  divisible (MQA archs like gemma-2b/granite-34b replicate the tiny KV
  projections and instead shard the decode cache along the *sequence*);
* ``batch`` / ``serve_batch`` → ("pod","data") iff the global batch divides
  the total DP size (long_500k's batch=1 replicates and gives its cache
  sequence both axes);
* ``kv_seq`` → "model" when KV heads can't shard; ("data","model") when the
  batch doesn't shard either (long-context decode = sequence parallelism
  over the whole mesh).
"""

from __future__ import annotations

import dataclasses

import math

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import AxisRules
from repro_torch.launch.mesh import mesh_axis_size


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    rules: AxisRules
    kv_heads_sharded: bool  # cache layout: heads-sharded vs seq-sharded
    batch_sharded: bool

    def describe(self) -> dict:
        return {
            "rules": {k: v for k, v in self.rules.rules},
            "kv_heads_sharded": self.kv_heads_sharded,
            "batch_sharded": self.batch_sharded,
        }


def build_policy(cfg: ArchConfig, cell: ShapeCell, mesh) -> ShardingPolicy:
    msize = mesh_axis_size(mesh, "model")
    dp_total = mesh_axis_size(mesh, "data") * mesh_axis_size(mesh, "pod")

    div = lambda n: n > 0 and n % msize == 0
    batch_ok = cell.global_batch % dp_total == 0

    heads_ok = div(cfg.n_heads * cfg.head_dim) and div(cfg.n_heads)
    kv_ok = div(cfg.n_kv_heads)
    ssm_ok = div(cfg.n_ssm_heads) if cfg.ssm_state else False
    experts_ok = cfg.is_moe and div(cfg.n_experts)
    vocab_ok = cfg.padded_vocab % msize == 0

    # sequence-shard the decode cache when KV heads can't shard; when the
    # batch is also unsharded (long_500k) give the sequence the data axis too
    kv_heads_sharded = kv_ok and batch_ok
    if not batch_ok:
        kv_seq_target: tuple[str, ...] | str | None = ("data", "model")
    elif not kv_ok:
        kv_seq_target = "model"
    else:
        kv_seq_target = None

    rules = AxisRules(
        rules=(
            ("batch", ("pod", "data") if batch_ok else None),
            ("serve_batch", ("pod", "data") if batch_ok else None),
            ("vocab", "model" if vocab_ok else None),
            ("heads", "model" if heads_ok else None),
            ("kv_heads", "model" if (kv_ok and kv_heads_sharded) else None),
            ("ffn", "model"),
            ("experts", "model" if experts_ok else None),
            ("ssm_heads", "model" if ssm_ok else None),
            ("kv_seq", kv_seq_target),
            ("seq_data", "data" if not batch_ok else None),
            ("layers", None),
            ("embed", None),
            ("seq", None),
            ("head_dim", None),
            ("state", None),
            ("conv", None),
            ("codebooks", None),
        )
    )
    return ShardingPolicy(
        rules=rules,
        kv_heads_sharded=kv_heads_sharded,
        batch_sharded=batch_ok,
    )


def pure_dp_policy(cfg: ArchConfig, cell: ShapeCell, mesh) -> ShardingPolicy:
    """Fold the model axis into data parallelism (small-model train cells).

    For models whose per-chip weight shard is tiny, TP's per-layer
    all-reduces dominate; running 256-way DP instead trades them for one
    gradient all-reduce per step (§Perf hillclimb B).
    """
    dp_total = math.prod(mesh.shape)
    batch_ok = cell.global_batch % dp_total == 0
    axes_all = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
    rules = AxisRules(
        rules=(
            ("batch", axes_all if batch_ok else None),
            ("serve_batch", axes_all if batch_ok else None),
            ("vocab", None),
            ("heads", None),
            ("kv_heads", None),
            ("ffn", None),
            ("experts", None),
            ("ssm_heads", None),
            ("kv_seq", None),
            ("seq_data", None),
            ("layers", None),
            ("embed", None),
            ("seq", None),
            ("head_dim", None),
            ("state", None),
            ("conv", None),
            ("codebooks", None),
        )
    )
    return ShardingPolicy(rules=rules, kv_heads_sharded=False, batch_sharded=batch_ok)
