"""Dry run over a fake process group: every (arch × shape × mesh) cell on
the production meshes, with no memory and no device (counterpart of
``repro.launch.dryrun``).

For each cell it builds the production mesh (16 x 16 single pod, 2 x 16 x
16 multi-pod) over a fake process group of 512 ranks, derives the sharding
policy, and places the parameters, the optimizer state (train cells;
Adafactor above :data:`ADAFACTOR_THRESHOLD` parameters), the decode cache
(decode cells) and the inputs as meta-device DTensors. It records:

* the bytes each rank holds, for each of these and in total, from the
  local shapes (``bytes_per_rank``);
* ``memory_analysis``, the counterpart of the reference's: the step (train
  step, prefill or decode step, run on the meta DTensors) runs under
  :class:`~repro_torch.launch.mem_count.MemCounter`, which counts the
  storages its ops create as the card's allocator would hold them
  (activations, saved tensors, gradients, gathered buffers and the
  kernels' outputs and workspace, whose wrappers allocate on meta tensors
  what they allocate on the card): ``argument_bytes`` (what the rank
  holds at the step's start), ``peak_bytes`` and ``temp_bytes`` (their
  difference), and ``lower_bound`` with its reason where a meta path is
  shapes only and saves less than the card's; ``fits`` is ``peak_bytes``
  within ``mem_util`` x ``hbm_bytes`` of an H100;
* the collectives the step issues (under
  :class:`~repro_torch.launch.comm_count.CommCounter`, around the
  ``MemCounter``), and the roofline on
  :data:`~repro_torch.core.cost_model.H100_SXM` from the analytic cost and
  those collectives, with ``useful_flops_fraction``, the model FLOPs (6 N D
  or 2 N D) over that count; status ``"ok"``;
* status ``"skipped"`` where ``shape_applicable`` rules the cell out.

``--remat {full,dots,none}`` (default full) and ``--kv-dtype {bf16,int8}``
(default bf16) are passed to the model and to the analytic cost as the
reference's dry run passes them; the xLSTM and hybrid families keep a bf16
state whatever ``--kv-dtype`` says (the reference's ignore it too), and
their cost counts the flag's bytes as the reference's does.
``--causal-mode {triangle,masked}`` (default triangle) picks how the
analytic cost counts causal attention: ``triangle`` is what the port's
flash kernel computes (it never visits the blocks above the diagonal),
``masked`` the full square, the reference's default count.
``record["variant"]`` names the mode.

Records are JSON files under ``results/dryrun_torch/`` (``--out`` to put
them elsewhere).

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --arch llama3-70b --shape decode_32k train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-235b-a22b --shape decode_32k --kv-dtype int8
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --causal-mode masked
    python -m repro_torch.launch.dryrun --all      # every arch x shape x mesh
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import REGISTRY, SHAPES_BY_NAME, get_config, shape_applicable
from repro_torch.core.cost_model import H100_SXM
from repro_torch.distributed.sharding import distribute_tree, local_bytes, tree_placements, use_rules
from repro_torch.launch.analytic_cost import cell_cost
from repro_torch.launch.comm_count import CommCounter
from repro_torch.launch.mem_count import MemCounter, storage_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.policy import build_policy, pure_dp_policy
from repro_torch.launch.roofline import Roofline, model_flops_estimate
from repro_torch.models.model_zoo import KV_DTYPES, STATE_FAMILIES, Model
from repro_torch.models.remat import REMAT_MODES
from repro_torch.models.xlstm import SLSTM_SHAPES_ONLY, slstm_shapes_calls
from repro_torch.training.train_loop import (
    TrainConfig,
    abstract_train_state,
    make_train_step,
    opt_state_axes,
)

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "results",
    "dryrun_torch",
)

#: Use the factored-second-moment optimizer above this many parameters
#: (AdamW's state would not fit the mesh), as the reference's dry run does.
ADAFACTOR_THRESHOLD = 4e10

#: How the analytic cost counts causal attention: the triangle the port's
#: flash kernel computes (it never visits the blocks above the diagonal),
#: or the full square (``masked``, the reference's default).
CAUSAL_MODES = ("triangle", "masked")

MESHES = {False: "pod16x16", True: "pod2x16x16"}
WORLD = 512


def _fake_world() -> None:
    """A fake process group of :data:`WORLD` ranks (this process is rank
    0): collectives are recorded and return without moving data."""
    if dist.is_initialized():
        if dist.get_world_size() != WORLD:
            raise RuntimeError(f"the dry run needs a {WORLD}-rank group, found "
                               f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)


@functools.lru_cache(maxsize=None)
def _mesh(multi_pod: bool):
    _fake_world()
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    pure_dp: bool = False,
    remat: str = "full",
    kv_dtype: str = "bf16",
    causal_mode: str = "triangle",
    out_dir: str = RESULTS_DIR,
) -> dict:
    """Place and step one cell; returns its record, also saved as JSON
    under ``out_dir``."""
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape]
    record: dict = {"arch": arch, "shape": shape, "mesh": MESHES[multi_pod], "status": "error"}
    if not shape_applicable(cfg, cell):
        record["status"] = "skipped"
        record["reason"] = (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.family} family is full-attention"
        )
        _save(record, out_dir)
        return record

    t0 = time.perf_counter()
    mesh = _mesh(multi_pod)
    chips = mesh.size()
    policy = (pure_dp_policy if pure_dp else build_policy)(cfg, cell, mesh)
    rules = policy.rules
    model = Model(cfg, remat=remat,
                  kv_dtype="bf16" if cfg.family in STATE_FAMILIES else kv_dtype)
    record["pure_dp"] = pure_dp
    if causal_mode not in CAUSAL_MODES:
        raise ValueError(f"causal_mode must be one of {CAUSAL_MODES}, got {causal_mode!r}")
    record["variant"] = {"causal_mode": causal_mode, "remat": remat, "kv_dtype": kv_dtype}

    params = distribute_tree(model.abstract(), tree_placements(model.axes(), mesh, rules))
    batch = distribute_tree(model.input_specs(cell),
                            tree_placements(model.input_axes(cell), mesh, rules))
    held = {"params": local_bytes(params), "inputs": local_bytes(batch)}
    args = [params, batch]
    opt_name = "adamw"
    if cell.kind == "train":
        opt_name = "adafactor" if model.param_count() > ADAFACTOR_THRESHOLD else "adamw"
        tcfg = TrainConfig(optimizer=opt_name)
        _, o_abs = abstract_train_state(model, tcfg)
        opt_state = distribute_tree(o_abs, tree_placements(opt_state_axes(model, tcfg), mesh, rules))
        held["opt_state"] = local_bytes(opt_state)
        args.append(opt_state)
        record["optimizer"] = opt_name
        model_flops = model_flops_estimate(model.active_param_count(),
                                           cell.global_batch * cell.seq_len, train=True)
    elif cell.kind == "prefill":
        model_flops = model_flops_estimate(model.active_param_count(),
                                           cell.global_batch * cell.seq_len, train=False)
    else:
        cache_axes = model.cache_axes(cell, kv_shardable=policy.kv_heads_sharded)
        cache = distribute_tree(model.cache_specs(cell), tree_placements(cache_axes, mesh, rules))
        held["cache"] = local_bytes(cache)
        args.append(cache)
        model_flops = model_flops_estimate(model.active_param_count(), cell.global_batch,
                                           train=False)
    held["total"] = sum(held.values())
    t_place = time.perf_counter()

    slstm_before = slstm_shapes_calls()
    with use_rules(rules), CommCounter() as counter, MemCounter(storage_bytes(*args)) as mem:
        if cell.kind == "train":
            step_fn, _ = make_train_step(model, tcfg)
            step_fn(params, opt_state, batch, 0)
        else:
            with torch.no_grad():
                if cell.kind == "prefill":
                    model.prefill(params, batch)
                else:
                    model.decode_step(params, cache, batch)
    colls = counter.stats()
    memory = {"argument_bytes": mem.held_bytes, "peak_bytes": mem.peak_bytes,
              "temp_bytes": mem.temp_bytes}
    if slstm_shapes_calls() > slstm_before:
        memory["lower_bound"] = SLSTM_SHAPES_ONLY
    t_step = time.perf_counter()

    acost = cell_cost(
        cfg, cell, model.param_count(),
        moe_cf=1.25 if cell.kind == "train" else 2.0,
        optimizer=opt_name, remat=remat, causal_mode=causal_mode, kv_dtype=kv_dtype,
    )
    roof = Roofline(
        flops_total=acost.flops_total,
        bytes_total=acost.hbm_bytes,
        collective_bytes_per_chip=colls.wire_bytes_per_chip,
        chips=chips,
        hw=H100_SXM,
    ).as_dict()
    budget = H100_SXM.mem_util * H100_SXM.hbm_bytes
    record.update(
        status="ok",
        chips=chips,
        params=model.param_count(),
        policy=policy.describe(),
        place_s=round(t_place - t0, 2),
        step_s=round(t_step - t_place, 2),
        bytes_per_rank=held,
        memory_analysis=memory,
        hbm_budget_bytes=budget,
        fits=memory["peak_bytes"] <= budget,
        analytic_cost=acost.as_dict(),
        collectives={
            "counts": colls.counts,
            "wire_bytes_per_chip": colls.wire_bytes_per_chip,
            "by_op": colls.by_op,
        },
        roofline=roof,
        hardware=H100_SXM.name,
        model_flops=model_flops,
        useful_flops_fraction=model_flops / acost.flops_total if acost.flops_total else 0.0,
    )
    _save(record, out_dir)
    return record


def _save(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def summary(rec: dict) -> str:
    """One line for a record: per-rank held and peak bytes, fits and the
    three terms."""
    head = f"[{rec['status']}] {rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if rec["status"] != "ok":
        return head
    variant = rec["variant"]
    if (variant["remat"], variant["kv_dtype"], variant["causal_mode"]) != ("full", "bf16",
                                                                             "triangle"):
        head += (f" (remat {variant['remat']}, kv {variant['kv_dtype']}, "
                 f"causal {variant['causal_mode']})")
    r, mem = rec["roofline"], rec["memory_analysis"]
    bound = " (lower bound)" if "lower_bound" in mem else ""
    return (f"{head}: held {mem['argument_bytes'] / 1e9:.3f} GB, peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB{bound} a rank (fits {rec['fits']}), compute "
            f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, "
            f"collective {r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}, "
            f"useful_flops_fraction {rec['useful_flops_fraction']:.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", nargs="+", default=None)
    ap.add_argument("--shape", nargs="+", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every config x shape, on both meshes unless --multi-pod is given")
    ap.add_argument("--pure-dp", action="store_true",
                    help="fold the model axis into data parallelism")
    ap.add_argument("--remat", default="full", choices=REMAT_MODES)
    ap.add_argument("--kv-dtype", default="bf16", choices=KV_DTYPES)
    ap.add_argument("--causal-mode", default="triangle", choices=CAUSAL_MODES,
                    help="causal attention counted as the triangle the kernel computes "
                         "or as the masked square (the reference's default)")
    ap.add_argument("--out", default=RESULTS_DIR, help="directory of the JSON records")
    args = ap.parse_args()

    if args.all:
        meshes = (True,) if args.multi_pod else (False, True)
        cells = [(a, s, mp) for mp in meshes for a in REGISTRY for s in SHAPES_BY_NAME]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(a, s, args.multi_pod) for a in args.arch for s in args.shape]

    failures = 0
    for arch, shape, multi_pod in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=multi_pod, pure_dp=args.pure_dp,
                           remat=args.remat, kv_dtype=args.kv_dtype,
                           causal_mode=args.causal_mode, out_dir=args.out)
            print(summary(rec), flush=True)
            print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                                      "bytes_per_rank", "memory_analysis",
                                                      "fits", "roofline")}),
                  flush=True)
        except Exception as e:  # one cell's failure is recorded; the others still run
            failures += 1
            print(f"[FAIL] {arch} x {shape} x {MESHES[multi_pod]}: {type(e).__name__}: {e}")
            traceback.print_exc()
            _save({"arch": arch, "shape": shape, "mesh": MESHES[multi_pod], "status": "error",
                   "error": f"{type(e).__name__}: {e}"}, args.out)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
