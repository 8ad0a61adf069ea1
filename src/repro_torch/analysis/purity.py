"""sync-discipline: the torch tier's device loop reads the device only
where it says it does (the torch tier's counterpart of ``jit-purity``).

The reference's jax tier runs its loop inside ``lax.while_loop``, where
a side effect is traced once and replayed stale. The port's torch tier
runs its loop eagerly from the host, with every state tensor on the
device; what it must not do is read the device from the host (a sync that
stalls the stream) anywhere but at its declared sync points, each of which
counts itself, so that the ``host_syncs`` that ``last_run_stats()``
reports and the code agree. The loop also draws nothing from global RNG
state and reads no clock, so a seeded run replays bit for bit.

The loop scope is discovered from the manifest's ``sync.loop_roots``
(``Class.method`` or a module function) in its ``sync.files``: the
transitive closure over ``self.<method>()`` calls in the class and over
the module functions those call. Inside it, outside the manifest's
``sync_points``, this rule flags:

* host reads: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` and ``torch.cuda.synchronize()``;
* ``time.*`` clocks;
* global-state RNG: ``random.*``, ``torch.manual_seed``/``torch.seed``,
  and ``torch.rand/randn/randint/randperm/normal/bernoulli/multinomial``
  without ``generator=``;
* ``print``, ``input``, ``open`` and any ``global`` statement.

Each sync point must exist and increment ``self.<counter>``
(``sync.counter``). Legacy global-state NumPy RNG calls
(``np.random.seed``, ``np.random.rand``, ...) are flagged in any analyzed
file, as the reference's rule does: seeded ``np.random.default_rng``
generators are the repo-wide convention. The CUDA sources are outside an
AST rule (the manifest's ``csrc_note``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.core import Finding, Rule, SourceFile, register, unparse

_RNG_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}
_CLOCKS = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
_IMPURE_NAMES = {"print", "input", "open"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all"}
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
              "multinomial", "rand_like", "randn_like", "randint_like"}

_Def = ast.FunctionDef


def _is_cpu(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and unparse(node.func) == "torch.device"
            and bool(node.args) and _is_cpu(node.args[0]))


def _host_read(call: ast.Call) -> Optional[str]:
    """What a call reads to the host, or None."""
    fn = call.func
    if unparse(fn) == "torch.cuda.synchronize":
        return "`torch.cuda.synchronize()`"
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in _HOST_READS and not call.args:
        return f"`.{fn.attr}()`"
    if fn.attr == "to" and (any(_is_cpu(a) for a in call.args)
                            or any(k.arg == "device" and _is_cpu(k.value)
                                   for k in call.keywords)):
        return '`.to("cpu")`'
    return None


def _counts_sync(fn_def: ast.AST, counter: str) -> bool:
    """True when the function has ``self.<counter> += ...``."""
    for node in ast.walk(fn_def):
        if (isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == counter
                and unparse(node.target.value) == "self"):
            return True
    return False


@register
class SyncDisciplineRule(Rule):
    name = "sync-discipline"
    description = (
        "the torch tier's device loop reads the device only at its declared "
        "sync points, each counting host_syncs; no clocks, global RNG, "
        "print or global mutation in the loop"
    )

    def check(self, sf: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = list(self._check_global_rng(sf))
        cfg = self.manifest.get("sync", {})
        if not any(sf.matches(p) for p in cfg.get("files", [])):
            return findings
        sync_points = set(cfg.get("sync_points", {}))
        counter = cfg.get("counter", "host_syncs")
        funcs: Dict[str, _Def] = {
            n.name: n for n in getattr(sf.tree, "body", []) if isinstance(n, _Def)
        }
        classes: Dict[str, Dict[str, _Def]] = {
            c.name: {m.name: m for m in c.body if isinstance(m, _Def)}
            for c in getattr(sf.tree, "body", []) if isinstance(c, ast.ClassDef)
        }
        loop = self._closure(cfg.get("loop_roots", []), funcs, classes)
        points_seen = set()
        for (cls, name), fn_def in loop.items():
            if name in sync_points and cls is not None:
                points_seen.add(name)
                if not _counts_sync(fn_def, counter):
                    findings.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=fn_def.lineno,
                            message=(
                                f"sync point `{cls}.{name}` does not count "
                                f"`self.{counter}`"
                            ),
                            hint=(
                                f"add `self.{counter} += 1` so the host syncs "
                                f"last_run_stats() reports match the code"
                            ),
                        )
                    )
                continue
            findings.extend(self._check_body(fn_def, cls, sf))
        for name in sorted(sync_points - points_seen):
            findings.append(
                Finding(
                    rule=self.name,
                    path=sf.ident,
                    line=1,
                    message=f"sync point `{name}` is not reached from the loop roots",
                    hint="fix sync.sync_points / sync.loop_roots in the manifest",
                )
            )
        return findings

    @staticmethod
    def _closure(roots, funcs, classes) -> Dict[Tuple[Optional[str], str], _Def]:
        """(class or None, name) -> def of every function the loop reaches."""
        out: Dict[Tuple[Optional[str], str], _Def] = {}
        frontier: List[Tuple[Optional[str], str]] = []
        for root in roots:
            cls, _, name = root.rpartition(".")
            frontier.append((cls or None, name))
        while frontier:
            key = frontier.pop()
            if key in out:
                continue
            cls, name = key
            fn_def = (classes.get(cls, {}) if cls else funcs).get(name)
            if fn_def is None:
                continue
            out[key] = fn_def
            for node in ast.walk(fn_def):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (cls and isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                        and f.value.id == "self" and f.attr in classes.get(cls, {})):
                    frontier.append((cls, f.attr))
                elif isinstance(f, ast.Name) and f.id in funcs:
                    frontier.append((None, f.id))
        return out

    def _check_body(self, fn_def: _Def, cls: Optional[str], sf: SourceFile) -> Iterable[Finding]:
        where = f"{cls}.{fn_def.name}" if cls else fn_def.name
        out: List[Finding] = []

        def flag(node: ast.AST, what: str, hint: str) -> None:
            out.append(Finding(rule=self.name, path=sf.ident, line=node.lineno,
                               message=f"{what} inside the device loop (`{where}`)",
                               hint=hint))

        for node in ast.walk(fn_def):
            if isinstance(node, ast.Global):
                flag(node, "`global` mutation", "keep the loop's state on the loop object")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = unparse(node.func)
            read = _host_read(node)
            if read is not None:
                flag(node, f"host read {read}",
                     "read through a declared sync point (sync.sync_points), "
                     "which counts it, or keep the value on the device")
            elif name in _CLOCKS:
                flag(node, f"wall-clock read `{name}()`",
                     "time the loop from outside it")
            elif name in _IMPURE_NAMES:
                flag(node, f"side-effecting call `{name}(...)`",
                     "report from outside the loop")
            elif name.startswith("random.") or name in _TORCH_SEEDS or (
                name.startswith("torch.") and name[6:] in _TORCH_RNG
                and not any(k.arg == "generator" for k in node.keywords)
            ):
                flag(node, f"global-state RNG call `{name}(...)`",
                     "draw from an explicit torch.Generator / np.random.default_rng")
        return out

    def _check_global_rng(self, sf: SourceFile) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = unparse(node.func)
            if name.startswith("np.random.") or name.startswith("numpy.random."):
                tail = name.rsplit(".", 1)[1]
                if tail not in _RNG_OK:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=sf.ident,
                            line=node.lineno,
                            message=(
                                f"legacy global-state RNG `{name}(...)` — "
                                f"seeded determinism requires explicit "
                                f"generators"
                            ),
                            hint="use np.random.default_rng(seed)",
                        )
                    )
        return out
