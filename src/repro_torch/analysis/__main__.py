"""CLI for the port's simlint: ``python -m repro_torch.analysis [paths] [--json PATH]``.

Exit status is the CI contract: 0 when the tree is clean, 1 when any
finding survives suppressions and the tolerance manifest, 2 on usage
errors.  ``--json`` writes (or prints, with ``-``) a machine-readable
report: schema id, rule inventory, the tolerance manifest, and the
findings — CI archives it as an artifact.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.analysis.core import (
    SourceFile,
    analyze_files,
    default_rules,
    iter_python_files,
    registered_rules,
)
from repro_torch.analysis.manifest import DEFAULT_MANIFEST

REPORT_SCHEMA = "repro_torch.simlint/report-v1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simlint: static invariant checks for the port's DES "
        "three-tier contract (engine parity, guard discipline, dtype "
        "discipline, sync discipline, obs schema wiring).",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=[],
        help="files or directories to analyze (default: src/repro_torch or "
        "repro_torch under the current directory)",
    )
    ap.add_argument(
        "--json",
        metavar="PATH",
        default=None,
        help="write a JSON report ('-' for stdout)",
    )
    ap.add_argument(
        "--rules",
        metavar="NAMES",
        default=None,
        help="comma-separated subset of rules to run",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="list registered rules and exit"
    )
    ap.add_argument(
        "--manifest",
        action="store_true",
        help="dump the tolerance manifest as JSON and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(registered_rules().items()):
            scope = "project" if getattr(cls, "project", False) else "file"
            print(f"{name:18s} [{scope}]  {cls.description}")
        return 0
    if args.manifest:
        print(json.dumps(DEFAULT_MANIFEST, indent=2))
        return 0

    paths = args.paths
    if not paths:
        for cand in ("src/repro_torch", "repro_torch"):
            if Path(cand).is_dir():
                paths = [cand]
                break
        else:
            print("simlint: no paths given and no src/repro_torch found", file=sys.stderr)
            return 2

    rules = default_rules()
    if args.rules:
        want = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = want - {r.name for r in rules}
        if unknown:
            print(f"simlint: unknown rules {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in want]

    t0 = time.perf_counter()
    files = [SourceFile.load(p) for p in iter_python_files(paths)]
    findings = analyze_files(files, rules)
    elapsed = time.perf_counter() - t0

    for f in findings:
        print(f.format())
    status = "clean" if not findings else f"{len(findings)} finding(s)"
    print(
        f"simlint: {status} — {len(files)} files, "
        f"{len(rules)} rules, {elapsed * 1e3:.0f} ms"
    )

    if args.json is not None:
        report = {
            "schema": REPORT_SCHEMA,
            "paths": [str(p) for p in paths],
            "files_scanned": len(files),
            "elapsed_s": elapsed,
            "rules": [
                {
                    "name": r.name,
                    "description": r.description,
                    "scope": "project" if r.project else "file",
                }
                for r in rules
            ],
            "manifest": DEFAULT_MANIFEST,
            "findings": [f.to_dict() for f in findings],
        }
        blob = json.dumps(report, indent=2)
        if args.json == "-":
            print(blob)
        else:
            Path(args.json).write_text(blob + "\n")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
