"""The port's simlint (``repro_torch.analysis``) against the reference's.

* engine-parity, guard-discipline and event-schema are copies of the
  reference's rules: on the same fixture trees, with a manifest that names
  the fixture paths, both give the same findings (rule, file, line,
  message). The fixtures are copied here, not imported from
  ``tests/test_analysis.py``.
* dtype-discipline and sync-discipline are the port's own: a passing, a
  violating and a suppressed fixture each, then seeded mutations of a copy
  of the port's own DES engine, each of which must be reported.
* the port is clean under its own simlint; the CLI; the package imports
  neither jax nor the reference.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.analysis as ref_analysis  # noqa: E402
from repro.analysis.core import SourceFile as RefSourceFile  # noqa: E402
from repro.analysis.core import analyze_files as ref_analyze_files  # noqa: E402
from repro.analysis.guards import GuardDisciplineRule as RefGuardRule  # noqa: E402
from repro.analysis.parity import EngineParityRule as RefParityRule  # noqa: E402
from repro.analysis.schema import EventSchemaRule as RefSchemaRule  # noqa: E402

from repro_torch.analysis import DEFAULT_MANIFEST, analyze_paths, manifest_dict  # noqa: E402
from repro_torch.analysis.core import SourceFile, analyze_files, default_rules  # noqa: E402
from repro_torch.analysis.dtype import DtypeDisciplineRule  # noqa: E402
from repro_torch.analysis.guards import GuardDisciplineRule  # noqa: E402
from repro_torch.analysis.parity import EngineParityRule  # noqa: E402
from repro_torch.analysis.purity import SyncDisciplineRule  # noqa: E402
from repro_torch.analysis.schema import EventSchemaRule  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _write(root: Path, rel: str, code: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return p


def _key(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


def _both(paths, ref_rule, port_rule):
    """(reference findings, port findings) on the same files."""
    ref = ref_analyze_files([RefSourceFile.load(p) for p in paths], [ref_rule])
    port = analyze_files([SourceFile.load(p) for p in paths], [port_rule])
    return _key(ref), _key(port)


def _shared_manifest() -> dict:
    """The reference's manifest (its engine keys and ``repro/...`` paths,
    which the fixture trees use), with the port's ``device_tiers`` naming
    the reference's compiled tier."""
    m = copy.deepcopy(ref_analysis.DEFAULT_MANIFEST)
    m["device_tiers"] = ["jax"]
    return m


# ---------------------------------------------------------------------------
# guard-discipline: the same findings as the reference
# ---------------------------------------------------------------------------

GUARD_CASES = {
    "guarded": "class S:\n    def step(self):\n        if self.tracer is not None:\n"
               "            self.tracer.emit(ADMIT, 1)\n",
    "conjunction": "class S:\n    def step(self, mask):\n"
                   "        if self.tracer is not None and mask.any():\n"
                   "            self.tracer.emit(TRUNCATE, 2)\n",
    "early_return": "class S:\n    def step(self):\n        if self.tracer is None:\n"
                    "            return 0\n        self.tracer.emit(ARRIVAL, 3)\n        return 1\n",
    "conditional": "class S:\n    def tick(self, t):\n        return self.telemetry.sample(t) "
                   "if self.telemetry is not None else None\n",
    "unguarded": "class S:\n    def step(self):\n        self.tracer.emit(ADMIT, 1)\n",
    "wrong_receiver": "class S:\n    def step(self):\n        if self.telemetry is not None:\n"
                      "            self.tracer.emit(ADMIT, 1)\n",
    "nested_reguard": "class S:\n    def step(self):\n        if self.tracer is not None:\n"
                      "            def inner():\n                self.tracer.emit(ADMIT, 1)\n",
    "fault_runtime": "class S:\n    def route(self, t):\n        return self._fault_rt.blocked(t)\n",
    "suppressed": "class S:\n    def step(self):\n        self.tracer.emit(ADMIT, 1)"
                  "  # simlint: disable=guard-discipline\n",
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_discipline_matches_reference(tmp_path, case):
    p = _write(tmp_path, "repro/sim/m.py", GUARD_CASES[case])
    ref, port = _both([p], RefGuardRule(_shared_manifest()),
                      GuardDisciplineRule(_shared_manifest()))
    assert port == ref
    assert bool(port) == (case in ("unguarded", "wrong_receiver", "nested_reguard",
                                   "fault_runtime"))


# ---------------------------------------------------------------------------
# engine-parity: the same findings as the reference
# ---------------------------------------------------------------------------

REF_ENGINE_OK = """
class PoolSim:
    def step(self):
        self.preemption_count += 1
        self.rejection_count += 1
        self.truncation_count += 1
        if self.tracer is not None:
            self.tracer.emit(ADMIT, 1)
            self.tracer.emit(PREEMPT, 1)
            self.tracer.emit(TRUNCATE, 1)
            self.tracer.emit(REJECT, 1)
"""

DEVICE_ENGINE_OK = """
def init_pool():
    return {"npre": 0, "nrej": 0, "ntr": 0}

def update(st):
    return {"npre": st["npre"] + 1, "nrej": st["nrej"] + 1,
            "ntr": st["ntr"] + 1}

def run_fleet_jax(fleet):
    return FleetResult(
        summary=1, per_pool=2, router_stats=3, preemptions=4,
        rejections=5, truncations=6, telemetry=None, slo=None,
    )
"""

FLEET_OK = """
def _run_reference(self):
    return FleetResult(
        summary=1, per_pool=2, router_stats=3, preemptions=4,
        rejections=5, truncations=6, retries=0, timeouts=0, shed=0,
        instance_failures=0, availability=1.0, records=[],
        fail_records=[], telemetry=None, slo=None,
    )

def _run_vectorized(self):
    return FleetResult(
        summary=1, per_pool=2, router_stats=3, preemptions=4,
        rejections=5, truncations=6, retries=0, timeouts=0, shed=0,
        instance_failures=0, availability=1.0,
        fail_records=[], telemetry=None, slo=None,
    )
"""

PARITY_CASES = {
    "aligned": {},
    "missing_counter": {"vec": ("self.truncation_count += 1\n        ", "")},
    "unknown_counter": {"vec": ("self.truncation_count += 1",
                                "self.truncation_count += 1\n        self.mystery_count += 1")},
    "missing_event": {"vec": ("self.tracer.emit(PREEMPT, 1)\n            ", "")},
    "extra_event": {"vec": ("self.tracer.emit(REJECT, 1)",
                            "self.tracer.emit(REJECT, 1)\n            self.tracer.emit(SPILL, 1)")},
    "fleet_result_drift": {"fleet": ("availability=1.0,\n        fail_records=[], ", "")},
    "device_counter_renamed": {"dev": ('"npre"', '"n_pre"')},
    "suppressed": {"vec": ("self.truncation_count += 1",
                           "self.truncation_count += 1\n        "
                           "self.mystery_count += 1  # simlint: disable=engine-parity")},
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_engine_parity_matches_reference(tmp_path, case):
    src = {"vec": REF_ENGINE_OK, "fleet": FLEET_OK, "dev": DEVICE_ENGINE_OK}
    for which, (old, new) in PARITY_CASES[case].items():
        assert old in src[which]
        src[which] = src[which].replace(old, new)
    paths = [
        _write(tmp_path, "repro/sim/engine.py", REF_ENGINE_OK),
        _write(tmp_path, "repro/sim/vector_engine.py", src["vec"]),
        _write(tmp_path, "repro/sim/jax_engine.py", src["dev"]),
        _write(tmp_path, "repro/sim/fleet.py", src["fleet"]),
    ]
    ref, port = _both(paths, RefParityRule(_shared_manifest()),
                      EngineParityRule(_shared_manifest()))
    assert port == ref
    assert bool(port) == (case not in ("aligned", "suppressed"))


# ---------------------------------------------------------------------------
# event-schema: the same findings as the reference
# ---------------------------------------------------------------------------

EVENTS_OK = """
ARRIVAL, ADMIT, REJECT, CALIB_SYNC = range(4)
EVENT_NAMES = ("arrival", "admit", "reject", "calib_sync")
"""

EMITTER_OK = """
class S:
    def step(self):
        if self.tracer is not None:
            self.tracer.emit(ARRIVAL, 1)
            self.tracer.emit(ADMIT, 1)
            self.tracer.emit(REJECT, 1)
            self.tracer.emit(CALIB_SYNC, 1)
"""

VALIDATE_OK = """
REQUIRED_COLUMNS = ("t_sim",)
POOL_COLUMNS = ("queue_depth", "active")
REQUIRED_COLUMNS_V2 = ("retries",)
POOL_COLUMNS_V2 = ("down",)
"""

TIMESERIES_OK = """
class T:
    def sample(self, name):
        self.columns["t_sim"].append(0)
        self.columns["retries"].append(0)
        self.columns[f"queue_depth.{name}"].append(0)
        self.columns[f"active.{name}"].append(0)
        self.columns[f"down.{name}"].append(0)
"""

SCHEMA_CASES = {
    "wired": {},
    "name_order": {"events": ('"admit", "reject"', '"reject", "admit"')},
    "arity": {"events": (', "calib_sync"', "")},
    "dead_kind": {"emitter": ("self.tracer.emit(CALIB_SYNC, 1)\n", "pass\n")},
    "undeclared_kind": {"emitter": ("self.tracer.emit(CALIB_SYNC, 1)",
                                    "self.tracer.emit(CALIB_SYNC, 1)\n"
                                    "            self.tracer.emit(MYSTERY, 1)")},
    "validator_only_column": {"validate": ('"queue_depth", "active"',
                                           '"queue_depth", "active", "bogus"')},
    "unvalidated_family": {"timeseries": ('self.columns[f"down.{name}"].append(0)',
                                          'self.columns[f"down.{name}"].append(0)\n'
                                          '        self.columns[f"mystery.{name}"].append(0)')},
    "suppressed": {"events": ("ARRIVAL, ADMIT, REJECT, CALIB_SYNC = range(4)",
                              "ARRIVAL, ADMIT, REJECT, CALIB_SYNC = range(4)"
                              "  # simlint: disable=event-schema"),
                   "emitter": ("self.tracer.emit(CALIB_SYNC, 1)\n", "pass\n")},
}


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_event_schema_matches_reference(tmp_path, case):
    src = {"events": EVENTS_OK, "emitter": EMITTER_OK, "validate": VALIDATE_OK,
           "timeseries": TIMESERIES_OK}
    for which, (old, new) in SCHEMA_CASES[case].items():
        assert old in src[which]
        src[which] = src[which].replace(old, new)
    paths = [
        _write(tmp_path, "repro/obs/events.py", src["events"]),
        _write(tmp_path, "repro/sim/engine.py", src["emitter"]),
        _write(tmp_path, "repro/obs/validate.py", src["validate"]),
        _write(tmp_path, "repro/obs/timeseries.py", src["timeseries"]),
    ]
    m = _shared_manifest()
    m["telemetry"]["emitter_files"] = ["repro/sim/engine.py"]
    m["telemetry"]["unvalidated_families_ok"] = {}
    ref, port = _both(paths, RefSchemaRule(m), EventSchemaRule(m))
    assert port == ref
    assert bool(port) == (case not in ("wired", "suppressed"))


# ---------------------------------------------------------------------------
# dtype-discipline (the port's own)
# ---------------------------------------------------------------------------

ENGINE = "repro_torch/sim/torch_engine.py"


def _lint(tmp_path, rel, code, rule):
    return analyze_files([SourceFile.load(_write(tmp_path, rel, code))], [rule])


DTYPE_PASS = """
import math
import torch
F64 = torch.float64
I32 = torch.int32
F32 = torch.float32

def window_step(x):
    return x.to(F32) * torch.tensor(0.5, dtype=F32)

def rows(n):
    a = torch.zeros((n,), dtype=F64)
    b = torch.full((n,), math.inf, dtype=F64)
    c = torch.full((n,), -1, dtype=I32)
    d = torch.arange(n)
    return a, b, c, d, float(timing.w_base)
"""

DTYPE_BAD = {
    "alias_use": ("return a, b, c, d,", "return a.to(F32), b, c, d,"),
    "attribute": ("d = torch.arange(n)", "d = torch.arange(n).to(torch.bfloat16)"),
    "numpy_f32": ("d = torch.arange(n)", "d = np.float32(n)"),
    "cast": ("d = torch.arange(n)", "d = a.float()"),
    "dtype_string": ("d = torch.arange(n)", 'd = a.to(dtype="float16")'),
    "zeros_no_dtype": ("d = torch.arange(n)", "d = torch.zeros(n)"),
    "float_fill": ("b = torch.full((n,), math.inf, dtype=F64)", "b = torch.full((n,), math.inf)"),
    "float_tensor": ("d = torch.arange(n)", "d = torch.tensor([0.5, 1.0])"),
    "float_range": ("d = torch.arange(n)", "d = torch.arange(0.0, n)"),
    "roofline": ("float(timing.w_base)", "timing.w_base"),
    "default_dtype": ("d = torch.arange(n)", "d = torch.arange(n)\n    torch.set_default_dtype(F64)"),
}


def test_dtype_discipline_passes(tmp_path):
    assert _lint(tmp_path, ENGINE, DTYPE_PASS, DtypeDisciplineRule()) == []


@pytest.mark.parametrize("case", sorted(DTYPE_BAD))
def test_dtype_discipline_flags(tmp_path, case):
    old, new = DTYPE_BAD[case]
    assert old in DTYPE_PASS
    fs = _lint(tmp_path, ENGINE, DTYPE_PASS.replace(old, new), DtypeDisciplineRule())
    assert len(fs) == 1 and fs[0].rule == "dtype-discipline", fs
    # only the f64-critical files are held to it (set_default_dtype: anywhere)
    other = _lint(tmp_path, "repro_torch/models/x.py", DTYPE_PASS.replace(old, new),
                  DtypeDisciplineRule())
    assert len(other) == (case == "default_dtype")


def test_dtype_discipline_suppressed(tmp_path):
    code = DTYPE_PASS.replace("d = torch.arange(n)",
                              "d = torch.zeros(n)  # simlint: disable=dtype-discipline")
    assert _lint(tmp_path, ENGINE, code, DtypeDisciplineRule()) == []


# ---------------------------------------------------------------------------
# sync-discipline (the port's own)
# ---------------------------------------------------------------------------

SYNC_PASS = """
import numpy as np
import torch

def helper(x):
    return x + 1

class _FleetLoop:
    def _read(self, t):
        self.host_syncs += 1
        return t.cpu().numpy()

    def _read_all(self, *ts):
        self.host_syncs += 1
        return torch.stack(ts).tolist()

    def step(self, t):
        n, m = self._read_all(t.sum(), t.amax())
        return helper(t) * n

    def run(self):
        while self._read(self.t).any():
            self.step(self.t)

    def fold_records(self):
        return self.t.cpu().numpy()
"""

SYNC_BAD = {
    "item": ("return helper(t) * n", "return helper(t) * t.sum().item()"),
    "to_cpu": ("return x + 1", 'return x.to("cpu") + 1'),
    "synchronize": ("return helper(t) * n", "torch.cuda.synchronize()\n        return helper(t) * n"),
    "clock": ("return x + 1", "import time\n    return x + time.perf_counter()"),
    "global_rng": ("return x + 1", "return x + torch.rand(3)"),
    "manual_seed": ("return x + 1", "torch.manual_seed(0)\n    return x + 1"),
    "print": ("return x + 1", "print(x)\n    return x + 1"),
    "uncounted_sync": ("        self.host_syncs += 1\n        return torch.stack",
                       "        return torch.stack"),
    "legacy_np_rng": ("import torch\n", "import torch\nnp.random.seed(0)\n"),
}


def _sync_manifest() -> dict:
    m = manifest_dict()
    m["sync"]["files"] = [ENGINE]
    return m


def test_sync_discipline_passes(tmp_path):
    assert _lint(tmp_path, ENGINE, SYNC_PASS, SyncDisciplineRule(_sync_manifest())) == []


@pytest.mark.parametrize("case", sorted(SYNC_BAD))
def test_sync_discipline_flags(tmp_path, case):
    old, new = SYNC_BAD[case]
    assert old in SYNC_PASS
    fs = _lint(tmp_path, ENGINE, SYNC_PASS.replace(old, new), SyncDisciplineRule(_sync_manifest()))
    assert len(fs) == 1 and fs[0].rule == "sync-discipline", fs


def test_sync_discipline_suppressed(tmp_path):
    code = SYNC_PASS.replace("return helper(t) * n",
                             "return helper(t) * t.sum().item()  # simlint: disable=sync-discipline")
    assert _lint(tmp_path, ENGINE, code, SyncDisciplineRule(_sync_manifest())) == []


def test_host_reads_reached_from_the_loop_flagged(tmp_path):
    """``fold_records`` may read the device because the loop never calls
    it; once the loop does, its reads are the loop's."""
    code = SYNC_PASS.replace("            self.step(self.t)",
                             "            self.step(self.t)\n        self.fold_records()")
    line = code.splitlines().index("        return self.t.cpu().numpy()") + 1
    fs = _lint(tmp_path, ENGINE, code, SyncDisciplineRule(_sync_manifest()))
    assert sorted((f.line, f.message.split(" inside")[0]) for f in fs) == [
        (line, "host read `.cpu()`"), (line, "host read `.numpy()`")
    ], fs


# ---------------------------------------------------------------------------
# seeded mutations of the port's own engine
# ---------------------------------------------------------------------------

MUTATIONS = {
    # a host read in the round
    "item_in_pool_round": (
        "        ncomp = comp.sum(dim=-1, dtype=I32)\n",
        "        ncomp = comp.sum(dim=-1, dtype=I32)\n        ncomp_host = ncomp.sum().item()\n",
        "sync-discipline", ".item()",
    ),
    # a float32 tensor by torch's default
    "zeros_in_run_fleet_torch": (
        "    cols = _as_columns(trace)\n    n = len(cols)\n    spec, ordered, shells",
        "    cols = _as_columns(trace)\n    n = len(cols)\n    pad = torch.zeros(n)\n"
        "    spec, ordered, shells",
        "dtype-discipline", "torch.zeros",
    ),
    # the float32 alias outside the controller's scopes
    "f32_outside_scopes": (
        '"enq": full((P, I, S), 0.0, F64)',
        '"enq": full((P, I, S), 0.0, F32)',
        "dtype-discipline", "`F32`",
    ),
    # a sync point that does not count itself
    "uncounted_sync_point": (
        '        """Several device scalars (flags and counts) in one host read."""\n'
        "        self.host_syncs += 1\n",
        '        """Several device scalars (flags and counts) in one host read."""\n',
        "sync-discipline", "_read_all",
    ),
    # a carried counter renamed
    "npre_renamed": ('"npre"', '"n_pre"', "engine-parity", '"npre"'),
}


@pytest.fixture(scope="module")
def engine_tree(tmp_path_factory):
    """A copy of the port's DES package (the engines and the fleet) under
    ``repro_torch/sim``, so the default manifest's paths match."""
    root = tmp_path_factory.mktemp("port")
    shutil.copytree(SRC / "repro_torch" / "sim", root / "repro_torch" / "sim",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _lint_engine(root: Path, source: str):
    engine = root / "repro_torch" / "sim" / "torch_engine.py"
    original = engine.read_text()
    engine.write_text(source)
    try:
        return analyze_paths([root / "repro_torch"])
    finally:
        engine.write_text(original)


def test_engine_copy_is_clean(engine_tree):
    src = (SRC / "repro_torch" / "sim" / "torch_engine.py").read_text()
    assert _lint_engine(engine_tree, src) == []


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_engine_mutation_caught(engine_tree, case):
    old, new, rule, needle = MUTATIONS[case]
    src = (SRC / "repro_torch" / "sim" / "torch_engine.py").read_text()
    assert old in src
    fs = _lint_engine(engine_tree, src.replace(old, new))
    assert fs and all(f.rule == rule for f in fs), [f.format() for f in fs]
    assert any(needle in f.message for f in fs), [f.format() for f in fs]


# ---------------------------------------------------------------------------
# the port clean under its own simlint; rules, manifest, CLI, imports
# ---------------------------------------------------------------------------


def test_simlint_clean_on_port():
    findings = analyze_paths([SRC / "repro_torch"])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_default_rules_cover_contract():
    assert {r.name for r in default_rules()} == {
        "engine-parity",
        "guard-discipline",
        "dtype-discipline",
        "sync-discipline",
        "event-schema",
    }


def test_manifest_reasons_present():
    ev = DEFAULT_MANIFEST["events"]["missing_ok"]
    fr = DEFAULT_MANIFEST["fleet_result"]["missing_ok"]
    dt = DEFAULT_MANIFEST["dtype"]["float32_scope_ok"]
    tl = DEFAULT_MANIFEST["telemetry"]["unvalidated_families_ok"]
    sp = DEFAULT_MANIFEST["sync"]["sync_points"]
    for table in (*ev.values(), *fr.values(), *dt.values(), tl, sp):
        assert table
        for reason in table.values():
            assert isinstance(reason, str) and reason.strip()
    for note in ("x64_note", "kernels_note"):
        assert DEFAULT_MANIFEST["dtype"][note].strip()
    assert DEFAULT_MANIFEST["sync"]["csrc_note"].strip()
    assert DEFAULT_MANIFEST["schema"] == "repro_torch.simlint/manifest-v1"


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd)


def test_cli_clean_port_and_json(tmp_path):
    out = tmp_path / "report.json"
    res = _cli([str(SRC / "repro_torch"), "--json", str(out)], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean" in res.stdout and "5 rules" in res.stdout
    report = json.loads(out.read_text())
    assert report["schema"] == "repro_torch.simlint/report-v1"
    assert report["findings"] == []
    assert report["manifest"]["schema"] == "repro_torch.simlint/manifest-v1"


def test_cli_violation_exit_one(tmp_path):
    _write(tmp_path, "pkg/bad.py", "class S:\n    def f(self):\n        self.tracer.emit(A, 1)\n")
    res = _cli([str(tmp_path / "pkg"), "--json", "-"], tmp_path)
    assert res.returncode == 1
    assert "[guard-discipline]" in res.stdout


def test_cli_list_rules_and_manifest(tmp_path):
    res = _cli(["--list-rules"], tmp_path)
    assert res.returncode == 0 and "sync-discipline" in res.stdout
    res = _cli(["--manifest"], tmp_path)
    assert res.returncode == 0
    assert json.loads(res.stdout)["engines"]["torch"] == "repro_torch/sim/torch_engine.py"


def test_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.analysis as a\n"
        f"assert a.analyze_paths([{str(SRC / 'repro_torch')!r}]) == []\n"
        "assert not [k for k, v in sys.modules.items()\n"
        "            if v is not None and k.split('.')[0] in ('jax', 'repro', 'torch')]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr
