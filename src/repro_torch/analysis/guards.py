"""guard-discipline: zero-cost-when-off hooks must be None-guarded.

The DES hot paths promise "telemetry/tracing/faults off" runs are
bit-identical to runs of a build with the hooks deleted.  That only
holds if every emission site is *dominated* by an ``is None`` guard on
its receiver.  This rule checks, intra-procedurally, that each watched
call is reachable only where the receiver is proven non-None:

* ``if self.tracer is not None: ...`` (including ``and``-conjunctions:
  ``if self.tracer is not None and mask.any(): ...``),
* early-return style: ``if self.tracer is None: return ...`` followed by
  unguarded use in the remainder of the block,
* conditional expressions: ``x.m() if x is not None else d``,
* short-circuits: ``x is not None and x.emit(...)``,
* ``assert x is not None``.

Watched receivers are *attribute* expressions only (``self.tracer``);
bare local names are assumed to be aliases hoisted inside an already
guarded region (the common ``rt = self._fault_rt`` pattern — a local
alias's None-ness is not re-derivable syntactically).  Nested function
definitions start from an empty guard set: a closure may be called from
anywhere, so it must re-guard (or stay off the watched set).
"""

from __future__ import annotations

import ast
from typing import FrozenSet, Iterable, List, Set, Tuple

from repro_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    final_attr,
    receiver_of,
    register,
    unparse,
)

# (receiver trailing attribute names, watched method names or None=any)
WATCHED: Tuple[Tuple[FrozenSet[str], FrozenSet[str]], ...] = (
    (frozenset({"tracer", "events"}), frozenset({"emit"})),
    (frozenset({"telemetry"}), frozenset({"sample", "set_trace"})),
    (frozenset({"_fault_rt"}), frozenset()),  # empty set = any method
)


def _is_none(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _guard_sets(test: ast.expr) -> Tuple[Set[str], Set[str]]:
    """(non-None-if-true, non-None-if-false) receiver keys for a test."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, right = test.left, test.comparators[0]
        if _is_none(right):
            expr = left
        elif _is_none(left):
            expr = right
        else:
            return set(), set()
        key = unparse(expr)
        if isinstance(test.ops[0], ast.IsNot):
            return {key}, set()
        if isinstance(test.ops[0], ast.Is):
            return set(), {key}
        return set(), set()
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        pos, neg = _guard_sets(test.operand)
        return neg, pos
    if isinstance(test, ast.BoolOp):
        if isinstance(test.op, ast.And):
            pos: Set[str] = set()
            for v in test.values:
                pos |= _guard_sets(v)[0]
            return pos, set()
        neg: Set[str] = set()
        for v in test.values:
            neg |= _guard_sets(v)[1]
        return set(), neg
    return set(), set()


def _terminates(stmts: List[ast.stmt]) -> bool:
    """True when the block always leaves the enclosing suite."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.If):
        return _terminates(last.body) and _terminates(last.orelse)
    return False


@register
class GuardDisciplineRule(Rule):
    name = "guard-discipline"
    description = (
        "tracer/telemetry/fault-runtime emission sites must be dominated "
        "by an `is None` guard so off-mode stays bit-identical"
    )

    def check(self, sf: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = []
        self._walk_stmts(getattr(sf.tree, "body", []), frozenset(), sf, findings)
        return findings

    # -- statement-level domination walk ---------------------------------

    def _walk_stmts(self, stmts, guarded, sf, findings) -> None:
        g: Set[str] = set(guarded)
        for st in stmts:
            if isinstance(st, ast.If):
                self._scan_expr(st.test, g, sf, findings)
                pos, neg = _guard_sets(st.test)
                self._walk_stmts(st.body, frozenset(g | pos), sf, findings)
                self._walk_stmts(st.orelse, frozenset(g | neg), sf, findings)
                if neg and _terminates(st.body):
                    g |= neg  # `if x is None: return` dominates the rest
                if pos and st.orelse and _terminates(st.orelse):
                    g |= pos
            elif isinstance(st, ast.Assert):
                self._scan_expr(st.test, g, sf, findings)
                g |= _guard_sets(st.test)[0]
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in st.decorator_list:
                    self._scan_expr(d, g, sf, findings)
                self._walk_stmts(st.body, frozenset(), sf, findings)
            elif isinstance(st, ast.ClassDef):
                for d in st.decorator_list:
                    self._scan_expr(d, g, sf, findings)
                self._walk_stmts(st.body, frozenset(), sf, findings)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan_expr(st.iter, g, sf, findings)
                self._walk_stmts(st.body, frozenset(g), sf, findings)
                self._walk_stmts(st.orelse, frozenset(g), sf, findings)
            elif isinstance(st, ast.While):
                self._scan_expr(st.test, g, sf, findings)
                pos, _ = _guard_sets(st.test)
                self._walk_stmts(st.body, frozenset(g | pos), sf, findings)
                self._walk_stmts(st.orelse, frozenset(g), sf, findings)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._scan_expr(item.context_expr, g, sf, findings)
                self._walk_stmts(st.body, frozenset(g), sf, findings)
            elif isinstance(st, ast.Try):
                self._walk_stmts(st.body, frozenset(g), sf, findings)
                for h in st.handlers:
                    self._walk_stmts(h.body, frozenset(g), sf, findings)
                self._walk_stmts(st.orelse, frozenset(g), sf, findings)
                self._walk_stmts(st.finalbody, frozenset(g), sf, findings)
            else:
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        self._scan_expr(child, g, sf, findings)

    # -- expression-level walk with short-circuit guard tracking ---------

    def _scan_expr(self, expr, guarded, sf, findings) -> None:
        g: Set[str] = set(guarded)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                self._scan_expr(v, g, sf, findings)
                pos, neg = _guard_sets(v)
                g |= pos if isinstance(expr.op, ast.And) else neg
            return
        if isinstance(expr, ast.IfExp):
            self._scan_expr(expr.test, g, sf, findings)
            pos, neg = _guard_sets(expr.test)
            self._scan_expr(expr.body, g | pos, sf, findings)
            self._scan_expr(expr.orelse, g | neg, sf, findings)
            return
        if isinstance(expr, ast.Lambda):
            self._scan_expr(expr.body, frozenset(), sf, findings)
            return
        if isinstance(expr, ast.Call):
            self._check_call(expr, g, sf, findings)
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._scan_expr(child, g, sf, findings)

    def _check_call(self, call: ast.Call, guarded, sf, findings) -> None:
        recv = receiver_of(call)
        if recv is None or not isinstance(recv, ast.Attribute):
            return  # bare-name receivers are hoisted aliases; see docstring
        meth = call.func.attr  # type: ignore[union-attr]
        attr = final_attr(recv)
        watched = any(
            attr in attrs and (not meths or meth in meths)
            for attrs, meths in WATCHED
        )
        if not watched:
            return
        key = unparse(recv)
        if key in guarded:
            return
        findings.append(
            Finding(
                rule=self.name,
                path=sf.ident,
                line=call.lineno,
                message=(
                    f"`{key}.{meth}(...)` is not dominated by a "
                    f"`{key} is None` guard"
                ),
                hint=(
                    f"wrap the call in `if {key} is not None:` (or early-"
                    f"return when it is None) so hooks-off runs stay "
                    f"bit-identical and zero-cost"
                ),
            )
        )
