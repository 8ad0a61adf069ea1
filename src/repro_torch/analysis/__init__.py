"""simlint for the port: AST-based invariant checker for its three-tier DES
contract (the port's copy of ``repro.analysis``, stdlib-only).

The port's simulator promises what the reference's does — the
``reference``/``vectorized``/``torch`` backends interchangeable, float64
op-order discipline in the device engine and the event-time kernel, and
zero-cost-when-off telemetry/fault hooks — and its runtime equivalence
suites catch drift only where a test exercises it. ``repro_torch.analysis``
enforces the same contracts *statically*, from source alone (no numpy or
torch import is needed to run the pass).

Usage::

    python -m repro_torch.analysis src/repro_torch       # human-readable findings
    python -m repro_torch.analysis src/repro_torch --json report.json
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --manifest            # dump the tolerance manifest

Shipped rules (see each module's docstring for the precise semantics):

``engine-parity``     counters, event kinds, and FleetResult fields match
                      across the three engines, modulo the manifest.
``guard-discipline``  tracer/telemetry/fault emissions dominated by
                      ``is None`` guards (zero-cost-when-off).
``dtype-discipline``  no float32-family dtypes (module aliases resolved) or
                      implicit-float torch constructors in f64-critical
                      files; roofline constants wrapped; no
                      ``torch.set_default_dtype``.
``sync-discipline``   the torch tier's device loop reads the device only at
                      its declared sync points, each counting
                      ``host_syncs``; no clocks, global RNG, print or
                      global mutation in it.
``event-schema``      obs event kinds and telemetry v1/v2 columns wired
                      between events.py / timeseries.py / validate.py.

Suppressions: append ``# simlint: disable=<rule>[,<rule>]`` to the
flagged line (or the line above it); ``disable=all`` mutes every rule
for that line. Intentional torch-tier divergences belong in the
*tolerance manifest* (`repro_torch.analysis.manifest`) with a reason
string, not in inline suppressions.

Adding a rule: a ``Rule`` subclass in a module of this package, decorated
with ``@register`` and imported in ``core._ensure_builtin_rules``; its
tolerances in a section of ``manifest.DEFAULT_MANIFEST``, read through
``self.manifest`` so tests can inject fixture manifests; fixture tests in
``tests/test_torch_analysis.py`` (one passing, one violating, one
suppressed), and the "simlint is clean on src/repro_torch" test kept green.
"""

from repro_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    analyze_files,
    analyze_paths,
    default_rules,
    register,
    registered_rules,
)
from repro_torch.analysis.manifest import DEFAULT_MANIFEST, manifest_dict, manifest_json

__all__ = [
    "Finding",
    "Rule",
    "SourceFile",
    "analyze_files",
    "analyze_paths",
    "default_rules",
    "register",
    "registered_rules",
    "DEFAULT_MANIFEST",
    "manifest_dict",
    "manifest_json",
]
