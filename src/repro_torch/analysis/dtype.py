"""dtype-discipline: float64 op-order contract in the device engine.

Event times in the torch DES tier must be IEEE-754 identical to the host
engines, which means every tensor entering time arithmetic is float64 and
roofline constants flow through an explicit ``float``/``np.float64``
wrap. Within the manifest's f64-critical files this rule flags:

* references to reduced-precision dtypes (``torch.float32``/``float16``/
  ``bfloat16``/``half``/``torch.float``, ``np.float32``, the casts
  ``.float()``/``.half()``/``.bfloat16()`` and dtype strings) outside
  manifest-allowed scopes — the allowed scopes are the documented
  torch-tier divergences (the float32 AIMD controller mirror), recorded
  with reasons in the tolerance manifest;
* module-level dtype aliases, resolved: ``F32 = torch.float32`` is not
  itself a use, but every read of ``F32`` outside the allowed scopes is
  one (without this the rule would be vacuous for a file that names its
  dtypes once at the top);
* ``torch.zeros/ones/empty`` without ``dtype=``, and ``torch.full``/
  ``tensor``/``as_tensor``/``arange`` with a float fill, value or range
  and no ``dtype=`` — torch's default float dtype is float32;
* unwrapped reads of the roofline constants (``.w_base``/``.h_per_seq``)
  — they must pass through ``float()``/``np.float64()``;
* ``torch.set_default_dtype`` anywhere: it changes what every such
  constructor makes.

The reference's x64-entry check has no counterpart: torch has no x64 mode
(see the manifest's ``x64_note``). Device kernels (``repro_torch/kernels/*``)
are outside this rule's file set except ``sim_decode.py`` — see the
manifest's ``kernels_note``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from repro_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    enclosing_map,
    register,
    scope_chain,
    unparse,
)

_LOW_PRECISION = {"float32", "float16", "bfloat16", "half"}
_LOW_CASTS = {"float", "half", "bfloat16"}  # tensor methods casting to them
_ALWAYS_FLOAT = {"zeros", "ones", "empty"}  # float32 unless dtype= says
_FILL_CTORS = {"full": 1, "tensor": 0, "as_tensor": 0}  # -> index of the value
_FLOAT_NAMES = {"math.inf", "math.nan", "math.pi", "math.e", "np.inf", "np.nan"}


def _is_float_value(node: ast.expr) -> bool:
    """A float literal, a float-valued constant name, ``float(...)``, or a
    list/tuple holding one."""
    if isinstance(node, ast.Constant) and type(node.value) is float:
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_float_value(node.operand)
    if isinstance(node, ast.Attribute) and unparse(node) in _FLOAT_NAMES:
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "float":
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_float_value(e) for e in node.elts)
    return False


def _is_low_dtype(node: ast.expr) -> bool:
    """``torch.float32``-style attribute, ``torch.float`` or ``np.float32``."""
    if not isinstance(node, ast.Attribute):
        return False
    if node.attr in _LOW_PRECISION:
        return True
    return node.attr == "float" and unparse(node.value) == "torch"


def _dtype_aliases(tree: ast.AST) -> Dict[str, ast.Assign]:
    """Module-level ``NAME = <reduced-precision dtype>`` assignments (also
    through an earlier alias)."""
    out: Dict[str, ast.Assign] = {}
    for node in getattr(tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        if _is_low_dtype(v) or (isinstance(v, ast.Name) and v.id in out):
            out[node.targets[0].id] = node
    return out


@register
class DtypeDisciplineRule(Rule):
    name = "dtype-discipline"
    description = (
        "f64-critical files: no float32-family dtypes (aliases resolved) or "
        "implicit-float torch constructors; roofline constants wrapped in "
        "f64; no torch.set_default_dtype"
    )

    def check(self, sf: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = list(self._check_default_dtype(sf))
        cfg = self.manifest.get("dtype", {})
        if not any(sf.matches(p) for p in cfg.get("files", [])):
            return findings
        enclosing = enclosing_map(sf.tree)
        allowed_scopes: Set[str] = set()
        for path, scopes in cfg.get("float32_scope_ok", {}).items():
            if sf.matches(path):
                allowed_scopes |= set(scopes)
        const_attrs = set(cfg.get("const_attrs", []))
        wrappers = set(cfg.get("const_wrappers", ["float", "np.float64"]))
        aliases = _dtype_aliases(sf.tree)
        alias_defs = {id(a.value) for a in aliases.values()}

        parents = {}
        for node in ast.walk(sf.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        def allowed(node: ast.AST) -> bool:
            return bool(set(scope_chain(node, enclosing)) & allowed_scopes)

        def low(node: ast.AST, what: str) -> None:
            if allowed(node):
                return
            findings.append(
                Finding(
                    rule=self.name,
                    path=sf.ident,
                    line=node.lineno,
                    message=f"reduced-precision dtype {what} in an f64-critical file",
                    hint=(
                        "event-time math must stay float64; if this scope is an "
                        "intentional torch-tier divergence, record it under "
                        "dtype.float32_scope_ok in the tolerance manifest with "
                        "a reason"
                    ),
                )
            )

        for node in ast.walk(sf.tree):
            if _is_low_dtype(node) and id(node) not in alias_defs:
                low(node, f"`{unparse(node)}`")
            elif (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                  and node.id in aliases and id(node) not in alias_defs):
                low(node, f"`{node.id}` (= `{unparse(aliases[node.id].value)}`)")
            elif isinstance(node, ast.Call):
                fn = node.func
                if (isinstance(fn, ast.Attribute) and fn.attr in _LOW_CASTS
                        and not node.args and not node.keywords
                        and unparse(fn.value) not in ("torch", "np", "numpy")):
                    low(node, f"cast `.{fn.attr}()`")
                findings.extend(self._check_ctor(node, sf))
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if isinstance(v, ast.Constant) and v.value in _LOW_PRECISION:
                    low(v, f'string "{v.value}"')
            elif isinstance(node, ast.Attribute) and node.attr in const_attrs:
                par = parents.get(node)
                wrapped = (
                    isinstance(par, ast.Call)
                    and node in par.args
                    and unparse(par.func) in wrappers
                )
                if not wrapped:
                    findings.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=node.lineno,
                            message=(
                                f"roofline constant `{unparse(node)}` used "
                                f"without an explicit f64 wrap"
                            ),
                            hint=(
                                "wrap it in float()/np.float64() so device and "
                                "host accumulate identical event times"
                            ),
                        )
                    )
        return findings

    def _check_ctor(self, call: ast.Call, sf: SourceFile) -> Iterable[Finding]:
        fn = call.func
        if not (isinstance(fn, ast.Attribute) and unparse(fn.value) == "torch"):
            return ()
        name = fn.attr
        if any(k.arg in ("dtype", "out") for k in call.keywords):
            return ()
        if name in _ALWAYS_FLOAT:
            what = f"`torch.{name}(...)` without an explicit dtype"
        elif name in _FILL_CTORS:
            i = _FILL_CTORS[name]
            if not (i < len(call.args) and _is_float_value(call.args[i])):
                return ()  # ints, bools and arrays keep their dtype
            what = f"float value in `torch.{name}(...)` without an explicit dtype"
        elif name == "arange":
            if not any(_is_float_value(a) for a in call.args):
                return ()
            what = "float range in `torch.arange(...)` without an explicit dtype"
        else:
            return ()
        return (
            Finding(
                rule=self.name,
                path=sf.ident,
                line=call.lineno,
                message=f"{what} — torch's default float dtype is float32",
                hint="pass dtype= (torch.float64 for event times)",
            ),
        )

    def _check_default_dtype(self, sf: SourceFile) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and unparse(node.func) == "torch.set_default_dtype":
                yield Finding(
                    rule=self.name,
                    path=sf.ident,
                    line=node.lineno,
                    message="`torch.set_default_dtype(...)` changes the dtype "
                    "every implicit-float constructor makes",
                    hint="name the dtype at each constructor instead",
                )
