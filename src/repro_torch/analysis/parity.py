"""engine-parity: the three DES backends must write the same contract.

The port's core guarantee is that ``FleetSim(backend="reference" |
"vectorized" | "torch")`` are interchangeable.  This project-scoped rule
statically checks the written surface of that contract against the
tolerance manifest:

* **counters** — every canonical counter (``preemption_count``,
  ``rejection_count``, ``truncation_count``) is incremented by each
  engine under its manifest-declared symbol (host engines bump
  ``self.<name>``; the manifest's ``device_tiers`` (the torch tier) carry
  dict keys like ``"npre"`` in the device loop's state).  A ``self.*_count`` counter that one
  host engine writes but the manifest doesn't know is flagged: add it
  to all three engines *and* the manifest.
* **event kinds** — the hot-path event sets emitted by the host engines
  must match the canonical set exactly; device-tier omissions must be
  declared (with reasons) under ``events.missing_ok``.
* **FleetResult fields** — each backend's ``FleetResult(...)``
  constructor call passes the reference tier's canonical keyword set,
  minus only the fields declared missing-by-design for that tier.

The rule only fires when the analyzed file set contains the engine
files the manifest names, so running simlint on a subtree (or a test
fixture tree) skips it silently unless the fixtures provide them.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    final_attr,
    receiver_of,
    register,
)


def _host_counters(sf: SourceFile) -> Dict[str, int]:
    """``self.<x>_count += ...`` target names -> first line seen."""
    out: Dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.AugAssign) or not isinstance(
            node.op, ast.Add
        ):
            continue
        t = node.target
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            and t.attr.endswith("_count")
        ):
            out.setdefault(t.attr, node.lineno)
    return out


def _string_constant_count(sf: SourceFile, value: str) -> int:
    return sum(
        1
        for n in ast.walk(sf.tree)
        if isinstance(n, ast.Constant) and n.value == value
    )


def _emitted_kinds(sf: SourceFile) -> Set[str]:
    """Lower-cased event constant names passed to tracer/events .emit()."""
    kinds: Set[str] = set()
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (
            isinstance(node.func, ast.Attribute) and node.func.attr == "emit"
        ):
            continue
        recv = receiver_of(node)
        if recv is None or final_attr(recv) not in ("tracer", "events"):
            continue
        if node.args and isinstance(node.args[0], ast.Name):
            kinds.add(node.args[0].id.lower())
    return kinds


def _fleet_result_calls(sf: SourceFile, function: str) -> List[ast.Call]:
    """FleetResult(...) call sites lexically inside ``function``."""
    out: List[ast.Call] = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name != function:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = node.func
                name = (
                    callee.id
                    if isinstance(callee, ast.Name)
                    else callee.attr if isinstance(callee, ast.Attribute) else ""
                )
                if name == "FleetResult":
                    out.append(node)
    return out


@register
class EngineParityRule(Rule):
    name = "engine-parity"
    description = (
        "counter fields, event kinds, and FleetResult fields must match "
        "across the reference/vectorized/torch engines, modulo the "
        "tolerance manifest"
    )
    project = True

    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        engines: Dict[str, str] = self.manifest.get("engines", {})
        located: Dict[str, SourceFile] = {}
        for eng, path in engines.items():
            sf = self._find(files, path)
            if sf is not None:
                located[eng] = sf
        if len(located) < 2:
            return ()  # partial tree: nothing to compare
        findings: List[Finding] = []
        findings.extend(self._check_counters(located))
        findings.extend(self._check_events(located))
        findings.extend(self._check_fleet_result(files, located))
        return findings

    @staticmethod
    def _find(files: Sequence[SourceFile], path: str) -> Optional[SourceFile]:
        for sf in files:
            if sf.matches(path):
                return sf
        return None

    # -- counters --------------------------------------------------------

    def _check_counters(self, located: Dict[str, SourceFile]) -> Iterable[Finding]:
        out: List[Finding] = []
        counters: Dict[str, Dict[str, str]] = self.manifest.get("counters", {})
        known_symbols: Dict[str, Set[str]] = {}
        for canonical, per_engine in counters.items():
            for eng, sym in per_engine.items():
                known_symbols.setdefault(eng, set()).add(sym)

        device_tiers = set(self.manifest.get("device_tiers", []))
        for eng, sf in located.items():
            if eng in device_tiers:
                for canonical, per_engine in counters.items():
                    sym = per_engine.get(eng)
                    if sym is None:
                        continue
                    # carried counters appear at least twice: the state
                    # dict's init and the accumulation update.
                    if _string_constant_count(sf, sym) < 2:
                        out.append(
                            Finding(
                                rule=self.name,
                                path=sf.ident,
                                line=1,
                                message=(
                                    f"{eng} engine never carries counter key "
                                    f'"{sym}" (canonical `{canonical}`)'
                                ),
                                hint=(
                                    "add the key to the device loop's state "
                                    "init and accumulate it, or update the "
                                    "manifest counters table"
                                ),
                            )
                        )
                continue
            written = _host_counters(sf)
            for canonical, per_engine in counters.items():
                sym = per_engine.get(eng)
                if sym is not None and sym not in written:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=1,
                            message=(
                                f"{eng} engine never increments "
                                f"`self.{sym}` (canonical `{canonical}`)"
                            ),
                            hint=(
                                "all three engines must write the same "
                                "counter set; see the manifest counters table"
                            ),
                        )
                    )
            for sym, line in written.items():
                if sym not in known_symbols.get(eng, set()):
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=line,
                            message=(
                                f"counter `self.{sym}` is written by the "
                                f"{eng} engine but missing from the parity "
                                f"manifest"
                            ),
                            hint=(
                                "add it to every engine and to the manifest "
                                "counters table (with per-engine symbols)"
                            ),
                        )
                    )
        return out

    # -- event kinds -----------------------------------------------------

    def _check_events(self, located: Dict[str, SourceFile]) -> Iterable[Finding]:
        out: List[Finding] = []
        cfg = self.manifest.get("events", {})
        canonical = set(cfg.get("canonical", []))
        missing_ok: Dict[str, Dict[str, str]] = cfg.get("missing_ok", {})
        for eng, sf in located.items():
            emitted = _emitted_kinds(sf)
            allowed_missing = set(missing_ok.get(eng, {}))
            for kind in sorted(canonical - emitted - allowed_missing):
                out.append(
                    Finding(
                        rule=self.name,
                        path=sf.ident,
                        line=1,
                        message=(
                            f"{eng} engine never emits canonical event kind "
                            f"`{kind}`"
                        ),
                        hint=(
                            "emit it on the hot path (guarded) or declare "
                            "the omission with a reason under "
                            "events.missing_ok in the manifest"
                        ),
                    )
                )
            for kind in sorted(emitted - canonical):
                out.append(
                    Finding(
                        rule=self.name,
                        path=sf.ident,
                        line=1,
                        message=(
                            f"{eng} engine emits event kind `{kind}` that is "
                            f"not in the canonical engine event set"
                        ),
                        hint=(
                            "add the kind to events.canonical and to the "
                            "other engines (or their missing_ok entries)"
                        ),
                    )
                )
        return out

    # -- FleetResult construction ---------------------------------------

    def _check_fleet_result(
        self, files: Sequence[SourceFile], located: Dict[str, SourceFile]
    ) -> Iterable[Finding]:
        out: List[Finding] = []
        cfg = self.manifest.get("fleet_result", {})
        ctors: Dict[str, Dict[str, str]] = cfg.get("constructors", {})
        missing_ok: Dict[str, Dict[str, str]] = cfg.get("missing_ok", {})
        ref = ctors.get("reference")
        if ref is None:
            return ()
        ref_sf = self._find(files, ref["file"])
        if ref_sf is None:
            return ()
        ref_calls = _fleet_result_calls(ref_sf, ref["function"])
        if not ref_calls:
            return ()
        baseline = {k.arg for k in ref_calls[0].keywords if k.arg}
        for eng, loc in ctors.items():
            if eng == "reference":
                continue
            sf = self._find(files, loc["file"])
            if sf is None:
                continue
            allowed = set(missing_ok.get(eng, {}))
            for call in _fleet_result_calls(sf, loc["function"]):
                kwargs = {k.arg for k in call.keywords if k.arg}
                for fld in sorted(baseline - kwargs - allowed):
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=call.lineno,
                            message=(
                                f"{eng} FleetResult omits field `{fld}` the "
                                f"reference tier populates"
                            ),
                            hint=(
                                "populate it or declare it under "
                                "fleet_result.missing_ok with a reason"
                            ),
                        )
                    )
                for fld in sorted(kwargs - baseline):
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=call.lineno,
                            message=(
                                f"{eng} FleetResult passes field `{fld}` the "
                                f"reference tier does not"
                            ),
                            hint="add it to the reference constructor too",
                        )
                    )
        return out
