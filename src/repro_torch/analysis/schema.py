"""event-schema: obs event kinds and telemetry columns stay wired.

``repro_torch/obs/events.py`` declares the event-kind id space,
``repro_torch/obs/timeseries.py`` produces the telemetry column families, and
``repro_torch/obs/validate.py`` is the schema the exporters are validated
against.  Drift between the three (a kind declared but never emitted, a
validator column no producer writes, a produced family the validator
has never heard of) silently weakens the export contract.  This
project-scoped rule checks:

* the positional constant tuple in events.py (``ARRIVAL, DISPATCH, ...
  = range(N)``) lines up one-for-one with ``EVENT_NAMES`` (lower-cased
  constant name == name string, same arity);
* every declared kind is emitted by at least one manifest-listed
  emitter file, and every all-caps kind passed to ``.emit(...)``
  anywhere is declared (the dead/unknown-kind sweep only runs when the
  full emitter set is in the analyzed tree, so subtree runs don't
  false-positive);
* every column in validate.py's ``REQUIRED_COLUMNS``/``POOL_COLUMNS``
  (v1 + v2) is produced somewhere in timeseries.py, and every per-pool
  family timeseries.py emits (``f"<family>.{name}"``) is either
  validated or declared optional in the manifest's
  ``unvalidated_families_ok`` (with a reason).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import Finding, Rule, SourceFile, register

_FAMILY_RE = re.compile(r"^[a-z_]+\.(cat)?$")


def _tuple_assign(
    tree: ast.AST, target_name: str
) -> Optional[Tuple[int, List[str]]]:
    """(line, [string elements]) of ``TARGET = ("a", "b", ...)``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id == target_name):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [
                e.value
                for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
            return node.lineno, vals
    return None


def _kind_constants(tree: ast.AST) -> Optional[Tuple[int, List[str]]]:
    """(line, names) of the ``A, B, ... = range(N)`` unpack in events.py."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (
            isinstance(t, ast.Tuple)
            and len(t.elts) >= 4
            and all(isinstance(e, ast.Name) for e in t.elts)
        ):
            continue
        v = node.value
        if (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Name)
            and v.func.id == "range"
        ):
            return node.lineno, [e.id for e in t.elts]
    return None


def _emit_kind_sites(sf: SourceFile) -> List[Tuple[str, int]]:
    """(ALL_CAPS first-arg name, line) for every ``*.emit(KIND, ...)``."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (
            isinstance(node.func, ast.Attribute) and node.func.attr == "emit"
        ):
            continue
        if node.args and isinstance(node.args[0], ast.Name):
            name = node.args[0].id
            if name.isupper():
                out.append((name, node.lineno))
    return out


def _produced_tokens(sf: SourceFile) -> Tuple[Set[str], Set[str]]:
    """(plain string constants, per-entity family prefixes) in a module.

    A family prefix is the leading constant of an f-string shaped like
    ``f"queue_depth.{p}"`` / ``f"calib_err.cat{k}"``.
    """
    plain: Set[str] = set()
    families: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            plain.add(node.value)
        elif isinstance(node, ast.JoinedStr) and node.values:
            head = node.values[0]
            if isinstance(head, ast.Constant) and isinstance(head.value, str):
                if _FAMILY_RE.match(head.value):
                    families.add(head.value.split(".", 1)[0])
    return plain, families


@register
class EventSchemaRule(Rule):
    name = "event-schema"
    description = (
        "obs event kinds and telemetry v1/v2 columns must stay wired "
        "between events.py, timeseries.py, and validate.py"
    )
    project = True

    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        cfg = self.manifest.get("telemetry", {})
        events_sf = self._find(files, cfg.get("events_file", ""))
        findings: List[Finding] = []
        if events_sf is not None:
            findings.extend(self._check_constant_names(events_sf))
            findings.extend(self._check_kind_usage(events_sf, files, cfg))
        validate_sf = self._find(files, cfg.get("validate_file", ""))
        ts_sf = self._find(files, cfg.get("timeseries_file", ""))
        if validate_sf is not None and ts_sf is not None:
            findings.extend(self._check_columns(validate_sf, ts_sf, cfg))
        return findings

    @staticmethod
    def _find(files: Sequence[SourceFile], path: str) -> Optional[SourceFile]:
        if not path:
            return None
        for sf in files:
            if sf.matches(path):
                return sf
        return None

    def _check_constant_names(self, events_sf: SourceFile) -> Iterable[Finding]:
        consts = _kind_constants(events_sf.tree)
        names = _tuple_assign(events_sf.tree, "EVENT_NAMES")
        if consts is None or names is None:
            return ()
        cline, cnames = consts
        nline, nvals = names
        out: List[Finding] = []
        if len(cnames) != len(nvals):
            out.append(
                Finding(
                    rule=self.name,
                    path=events_sf.ident,
                    line=nline,
                    message=(
                        f"{len(cnames)} event-kind constants but "
                        f"{len(nvals)} entries in EVENT_NAMES"
                    ),
                    hint="keep the unpack tuple and EVENT_NAMES in lockstep",
                )
            )
        for i, (c, n) in enumerate(zip(cnames, nvals)):
            if c.lower() != n:
                out.append(
                    Finding(
                        rule=self.name,
                        path=events_sf.ident,
                        line=nline,
                        message=(
                            f"EVENT_NAMES[{i}] is \"{n}\" but constant #{i} "
                            f"is {c} — positional id/name mismatch"
                        ),
                        hint=(
                            "EVENT_NAMES must be the lower-cased constants "
                            "in declaration order (ids index into it)"
                        ),
                    )
                )
        return out

    def _check_kind_usage(
        self, events_sf: SourceFile, files: Sequence[SourceFile], cfg: dict
    ) -> Iterable[Finding]:
        consts = _kind_constants(events_sf.tree)
        if consts is None:
            return ()
        cline, declared = consts
        emitters = cfg.get("emitter_files", [])
        located = [self._find(files, p) for p in emitters]
        if any(sf is None for sf in located) or not located:
            return ()  # partial tree: skip the dead-kind sweep
        out: List[Finding] = []
        used: Set[str] = set()
        for sf in located:
            for name, line in _emit_kind_sites(sf):
                used.add(name)
                if name not in declared:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=line,
                            message=(
                                f"emit() of `{name}`, which events.py does "
                                f"not declare"
                            ),
                            hint="add the kind to events.py (+ EVENT_NAMES)",
                        )
                    )
        for name in declared:
            if name not in used:
                out.append(
                    Finding(
                        rule=self.name,
                        path=events_sf.ident,
                        line=cline,
                        message=(
                            f"event kind `{name}` is declared but no emitter "
                            f"file ever emits it"
                        ),
                        hint=(
                            "emit it somewhere or drop the kind (and its "
                            "EVENT_NAMES entry)"
                        ),
                    )
                )
        return out

    def _check_columns(
        self, validate_sf: SourceFile, ts_sf: SourceFile, cfg: dict
    ) -> Iterable[Finding]:
        plain, families = _produced_tokens(ts_sf)
        unvalidated_ok = set(cfg.get("unvalidated_families_ok", {}))
        out: List[Finding] = []
        pool_known: Set[str] = set()
        for var in (
            "REQUIRED_COLUMNS",
            "REQUIRED_COLUMNS_V2",
            "POOL_COLUMNS",
            "POOL_COLUMNS_V2",
        ):
            got = _tuple_assign(validate_sf.tree, var)
            if got is None:
                continue
            line, cols = got
            per_pool = var.startswith("POOL")
            if per_pool:
                pool_known |= set(cols)
            for col in cols:
                produced = col in plain or (per_pool and col in families)
                if not produced:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=validate_sf.ident,
                            line=line,
                            message=(
                                f"validator column \"{col}\" ({var}) is "
                                f"never produced by the telemetry writer"
                            ),
                            hint=(
                                f"produce it in {ts_sf.ident} or drop it "
                                f"from {var}"
                            ),
                        )
                    )
        if pool_known:
            for fam in sorted(families - pool_known - unvalidated_ok):
                out.append(
                    Finding(
                        rule=self.name,
                        path=ts_sf.ident,
                        line=1,
                        message=(
                            f"telemetry emits per-pool family "
                            f"\"{fam}.*\" the validator does not know"
                        ),
                        hint=(
                            "add it to POOL_COLUMNS(_V2) or declare it "
                            "under telemetry.unvalidated_families_ok with "
                            "a reason"
                        ),
                    )
                )
        return out
