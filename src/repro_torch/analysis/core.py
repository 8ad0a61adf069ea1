"""simlint core: source loading, suppressions, rule registry, runner (the
port's copy of ``repro.analysis.core``).

Everything here is stdlib-only (``ast`` + ``re`` + ``pathlib``) so the CI
gate can run without installing the numeric stack.

Vocabulary
----------
``SourceFile``
    One parsed ``.py`` file: raw text, AST, and the per-line suppression
    table built from ``# simlint: disable=<rule>[,<rule>...]`` comments.
``Rule``
    A named check.  File-scoped rules implement :meth:`Rule.check` and
    see one file at a time; project-scoped rules (``project = True``)
    implement :meth:`Rule.check_project` and see the whole parsed file
    set at once (used for cross-engine parity and schema wiring).
``Finding``
    One violation: rule name, file, line, message, and a fix hint.

Suppression semantics: a finding at line *L* is dropped when line *L* or
line *L-1* carries a ``# simlint: disable=`` comment naming the rule (or
``all``).  Project rules anchor cross-file findings to a concrete line in
the offending file, so the same mechanism covers them.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

#: Path components a file's identity starts at (the port's package, and the
#: reference's, so one fixture tree reads the same to both checkers).
PACKAGE_ROOTS = ("repro_torch", "repro")

_SUPPRESS_RE = re.compile(r"#\s*simlint:\s*disable(?:=([A-Za-z0-9_,\- ]+))?")


@dataclass(frozen=True)
class Finding:
    """One rule violation with enough context to jump to and fix it."""

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def format(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
        }


@dataclass
class SourceFile:
    """A parsed source file plus its simlint suppression table."""

    path: Path
    text: str
    tree: ast.AST
    # line number -> set of suppressed rule names (or {"all"})
    suppressions: Dict[int, set] = field(default_factory=dict)

    @property
    def ident(self) -> str:
        """Stable repo-relative identity, e.g. ``repro_torch/sim/engine.py``.

        Starts at the last ``repro_torch`` (or ``repro``) path component
        when present so the tolerance manifest can name files independently
        of where the checkout (or a test fixture tree) lives on disk.
        """
        parts = self.path.as_posix().split("/")
        roots = [i for i, part in enumerate(parts[:-1]) if part in PACKAGE_ROOTS]
        if roots:
            return "/".join(parts[roots[-1]:])
        return self.path.name

    @classmethod
    def load(cls, path: Path) -> "SourceFile":
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
        sup: Dict[int, set] = {}
        for i, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m is None:
                continue
            names = m.group(1)
            if names is None:
                sup[i] = {"all"}
            else:
                sup[i] = {n.strip() for n in names.split(",") if n.strip()}
        return cls(path=path, text=text, tree=tree, suppressions=sup)

    def matches(self, manifest_path: str) -> bool:
        """True when this file is the one a manifest entry names."""
        ident = self.ident
        return ident == manifest_path or ident.endswith("/" + manifest_path)

    def suppressed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            names = self.suppressions.get(ln)
            if names and (rule in names or "all" in names):
                return True
        return False


class Rule:
    """Base class for simlint rules.  Subclass + :func:`register`."""

    name: str = ""
    description: str = ""
    project: bool = False  # project rules see all files at once

    def __init__(self, manifest: Optional[dict] = None):
        if manifest is None:
            from repro_torch.analysis.manifest import DEFAULT_MANIFEST

            manifest = DEFAULT_MANIFEST
        self.manifest = manifest

    # file-scoped entry point
    def check(self, sf: SourceFile) -> Iterable[Finding]:
        return ()

    # project-scoped entry point
    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator adding a Rule subclass to the global registry."""
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    _REGISTRY[cls.name] = cls
    return cls


def registered_rules() -> Dict[str, type]:
    _ensure_builtin_rules()
    return dict(_REGISTRY)


def default_rules(manifest: Optional[dict] = None) -> List[Rule]:
    """Fresh instances of every registered rule (optionally with a
    fixture manifest — tests use this to seed tolerances)."""
    _ensure_builtin_rules()
    return [cls(manifest) for cls in _REGISTRY.values()]


def _ensure_builtin_rules() -> None:
    # Importing the rule modules registers them; idempotent.
    from repro_torch.analysis import dtype, guards, parity, purity, schema  # noqa: F401


def iter_python_files(paths: Sequence) -> List[Path]:
    out: List[Path] = []
    seen = set()
    for p in paths:
        p = Path(p)
        if p.is_dir():
            cands = sorted(q for q in p.rglob("*.py") if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            cands = [p]
        else:
            continue
        for q in cands:
            r = q.resolve()
            if r not in seen:
                seen.add(r)
                out.append(q)
    return out


def analyze_files(
    files: Sequence[SourceFile], rules: Optional[Sequence[Rule]] = None
) -> List[Finding]:
    """Run rules over already-parsed files, honoring suppressions."""
    if rules is None:
        rules = default_rules()
    by_ident = {sf.ident: sf for sf in files}
    findings: List[Finding] = []

    def keep(f: Finding) -> bool:
        sf = by_ident.get(f.path) or next(
            (s for s in files if str(s.path) == f.path), None
        )
        return sf is None or not sf.suppressed(f.line, f.rule)

    for rule in rules:
        if rule.project:
            findings.extend(f for f in rule.check_project(files) if keep(f))
        else:
            for sf in files:
                findings.extend(f for f in rule.check(sf) if keep(f))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_paths(
    paths: Sequence, rules: Optional[Sequence[Rule]] = None
) -> List[Finding]:
    """Parse ``paths`` (files or directories) and run the rule set."""
    files = [SourceFile.load(p) for p in iter_python_files(paths)]
    return analyze_files(files, rules)


# ---------------------------------------------------------------------------
# Shared AST helpers used by several rules.
# ---------------------------------------------------------------------------


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed synthetic nodes only
        return "<expr>"


def receiver_of(call: ast.Call) -> Optional[ast.expr]:
    """For ``a.b.meth(...)`` return the ``a.b`` expression, else None."""
    if isinstance(call.func, ast.Attribute):
        return call.func.value
    return None


def final_attr(expr: ast.expr) -> Optional[str]:
    """Trailing attribute name of a receiver: ``self.tracer`` -> ``tracer``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def walk_functions(tree: ast.AST) -> Iterator[ast.AST]:
    """Yield every function/async-function definition in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def enclosing_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """node -> nearest enclosing function/class def (parent scope map)."""
    out: Dict[ast.AST, ast.AST] = {}

    def visit(node: ast.AST, scope: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if scope is not None:
                out[child] = scope
            nxt = scope
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                nxt = child
            visit(child, nxt)

    visit(tree, None)
    return out


def scope_chain(node: ast.AST, enclosing: Dict[ast.AST, ast.AST]) -> List[str]:
    """Names of the function/class scopes containing ``node``, inner-first."""
    chain: List[str] = []
    cur = enclosing.get(node)
    while cur is not None:
        chain.append(getattr(cur, "name", "<scope>"))
        cur = enclosing.get(cur)
    return chain
