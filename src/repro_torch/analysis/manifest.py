"""simlint tolerance manifest: the port's three-tier equivalence contract.

This module is the machine-readable form of the contract the port's
runtime equivalence suites check empirically (``tests/test_torch_sim.py``
holds ``FleetSim(backend="torch")`` against the host tiers and the
reference's jax tier): which counters, events and result fields every DES
backend must produce, which divergences of the device-resident ``torch``
tier are *intentional* and bounded by their own tests, where float32 is
allowed in the float64 event-time files, and where the device loop may
read the device from the host.

Every allowance carries a reason string. Adding an entry here is a
reviewed statement "this divergence is by design"; prefer it over inline
``# simlint: disable=`` comments for anything that is part of the tier
contract (inline suppressions are for one-off local exceptions).

``python -m repro_torch.analysis --manifest`` dumps this as JSON.
"""

from __future__ import annotations

import copy
import json

SCHEMA = "repro_torch.simlint/manifest-v1"

DEFAULT_MANIFEST: dict = {
    "schema": SCHEMA,
    # ------------------------------------------------------------------
    # The three interchangeable DES backends (suffix-matched on path).
    # ------------------------------------------------------------------
    "engines": {
        "reference": "repro_torch/sim/engine.py",
        "vectorized": "repro_torch/sim/vector_engine.py",
        "torch": "repro_torch/sim/torch_engine.py",
    },
    # Tiers that carry their counters as dict keys of device state (the
    # loop's ``st`` dict) rather than as ``self.<name>_count`` attributes.
    "device_tiers": ["torch"],
    # ------------------------------------------------------------------
    # engine-parity: counters. Canonical counter -> the symbol each
    # engine must write. Host engines increment `self.<symbol>`; the
    # torch tier keeps (G, P) int32 tensors under these keys of the
    # loop's state dict (sim/torch_engine.py, _init_pools).
    # ------------------------------------------------------------------
    "counters": {
        "preemption_count": {
            "reference": "preemption_count",
            "vectorized": "preemption_count",
            "torch": "npre",
        },
        "rejection_count": {
            "reference": "rejection_count",
            "vectorized": "rejection_count",
            "torch": "nrej",
        },
        "truncation_count": {
            "reference": "truncation_count",
            "vectorized": "truncation_count",
            "torch": "ntr",
        },
    },
    # ------------------------------------------------------------------
    # engine-parity: event kinds each engine emits on its hot path. The
    # torch tier's round is one masked pass over every lane, pool and
    # slot on the device, with no per-request host step to emit from;
    # FleetSim(backend="torch") rejects event tracing up front
    # (sim/fleet.py, telemetry events=True raises), so the whole
    # canonical set is declared missing-by-design.
    # ------------------------------------------------------------------
    "events": {
        "canonical": ["admit", "preempt", "truncate", "reject"],
        "missing_ok": {
            "torch": {
                "admit": "no per-event host step inside the device loop; "
                "FleetSim raises if events are requested on the torch tier",
                "preempt": "counted in the carried npre counter instead",
                "truncate": "counted in the carried ntr counter instead",
                "reject": "counted in the carried nrej counter instead",
            }
        },
    },
    # ------------------------------------------------------------------
    # engine-parity: FleetResult construction. The reference
    # constructor is the canonical field set; other tiers may omit only
    # what is declared here.
    # ------------------------------------------------------------------
    "fleet_result": {
        "constructors": {
            "reference": {"file": "repro_torch/sim/fleet.py", "function": "_run_reference"},
            "vectorized": {"file": "repro_torch/sim/fleet.py", "function": "_run_vectorized"},
            "torch": {"file": "repro_torch/sim/torch_engine.py", "function": "run_fleet_torch"},
        },
        "missing_ok": {
            "vectorized": {
                "records": "outcomes stay columnar (summarize_columns); "
                "per-request Record objects are a reference-tier feature",
            },
            "torch": {
                "retries": "fault injection unsupported in the device loop; "
                "FleetSim(backend='torch') rejects an injector",
                "timeouts": "fault injection unsupported in the device loop; "
                "FleetSim(backend='torch') rejects an injector",
                "shed": "fault injection unsupported in the device loop; "
                "FleetSim(backend='torch') rejects an injector",
                "instance_failures": "fault injection unsupported in the "
                "device loop; FleetSim(backend='torch') rejects an injector",
                "availability": "defaults to 1.0; no fault runtime on this tier",
                "records": "fixed-shape (G, n) record tensors, no Record objects",
                "fail_records": "no fault runtime on this tier",
            },
        },
    },
    # ------------------------------------------------------------------
    # dtype-discipline: float64 op-order contract for DES time math.
    # Scoped to the device engine plus the one kernel that IS event-time
    # math (repro_torch/kernels/sim_decode.py — its plain version and the
    # CUDA kernel csrc/sim_decode.cu must accumulate bit-identical float64
    # event times). Other kernels pick compute precision explicitly per
    # accelerator (f32/bf16 accumulators) and stay outside the contract.
    # ------------------------------------------------------------------
    "dtype": {
        "files": [
            "repro_torch/sim/torch_engine.py",
            "repro_torch/kernels/sim_decode.py",
        ],
        "float32_scope_ok": {
            "repro_torch/sim/torch_engine.py": {
                "window_step": "in-loop AIMD controller mirror keeps gains "
                "and pressure ratios in float32 over the lane axis; "
                "decisions are threshold comparisons, bounded by the "
                "gain-grid parity tests",
                "_ctrl_params": "controller gain pack mirrors window_step's "
                "float32 lanes",
                "_ctrl_lanes": "the gain pack's device tensors, the lanes of "
                "window_step's float32 controller mirror",
                "run_fleet_grid": "gain-grid rows feed the float32 "
                "controller mirror",
                "precompute_budget_trajectory": "EMA calibration state is "
                "float32 by the CalibState contract (core/calibration.py); "
                "the output is int32 budgets, never event-time math — "
                "cold-start parity tests bound it",
            }
        },
        "const_attrs": ["w_base", "h_per_seq"],
        "const_wrappers": ["float", "np.float64"],
        "x64_note": "the reference's x64_entries has no counterpart: torch "
        "has no x64 mode to enter (float64 is a dtype every tensor names, "
        "and the rule flags torch.set_default_dtype and float constructors "
        "that leave the dtype to torch's float32 default instead)",
        "kernels_note": "repro_torch/kernels/* excluded except "
        "sim_decode.py: the attention and scan kernels choose their own "
        "compute precision, but sim_decode advances DES event times and "
        "must hold the same float64 op-order contract as the engines; "
        "event-time constants flow through float() wraps of the timing "
        "model's roofline constants",
    },
    # ------------------------------------------------------------------
    # sync-discipline: the torch tier's device loop. Its roots are
    # methods of the loop class; the rule follows self.<method>() calls
    # and the module functions they call. Inside, only the sync points
    # read the device from the host, and each counts one host sync.
    # ------------------------------------------------------------------
    "sync": {
        "files": ["repro_torch/sim/torch_engine.py"],
        "loop_roots": ["_FleetLoop.run"],
        "sync_points": {
            "_read": "one device tensor on the host (the wakes, read "
            "once for all lanes when one has changed)",
            "_read_all": "the admission wave's and the round's flags and "
            "counts, stacked into one read",
        },
        "counter": "host_syncs",
        "csrc_note": "the CUDA sources (repro_torch/csrc/*.cu) are outside "
        "an AST rule: sim_decode.cu is held to the plain version bit for "
        "bit by the card tests instead",
    },
    # ------------------------------------------------------------------
    # event-schema: obs wiring. Telemetry column families the producer
    # emits that the validator intentionally does not require.
    # ------------------------------------------------------------------
    "telemetry": {
        "events_file": "repro_torch/obs/events.py",
        "validate_file": "repro_torch/obs/validate.py",
        "timeseries_file": "repro_torch/obs/timeseries.py",
        "emitter_files": [
            "repro_torch/sim/engine.py",
            "repro_torch/sim/vector_engine.py",
            "repro_torch/sim/fleet.py",
            "repro_torch/sim/faults.py",
            "repro_torch/obs/timeseries.py",
        ],
        "unvalidated_families_ok": {
            "threshold": "per-boundary count varies with pool count P; "
            "optional trajectory family",
            "calib_err": "per-category diagnostics; category count is "
            "config-dependent",
            "ema_ratio": "per-category diagnostics; category count is "
            "config-dependent",
        },
    },
}


def manifest_dict() -> dict:
    """Deep copy of the default tolerance manifest."""
    return copy.deepcopy(DEFAULT_MANIFEST)


def manifest_json(indent: int = 2) -> str:
    return json.dumps(DEFAULT_MANIFEST, indent=indent, sort_keys=False)
