#!/usr/bin/env python
"""Repo-metrics auditor for CI (capability parity: reference
scripts/gatekeeper_audit.py:12-36 — counts source/test files into a
0/50/75/100 readiness score, JSON to stdout)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def collect_evidence() -> dict:
    src = sorted((ROOT / "dewi").rglob("*.py"))
    tests = sorted((ROOT / "tests").glob("test_*.py"))
    return {
        "python_files": len(src),
        "test_files": len(tests),
        "has_cli": (ROOT / "dewi" / "cli.py").exists(),
        "has_bench": (ROOT / "bench.py").exists(),
        "has_schemas": (ROOT / "dewi" / "schemas.py").exists(),
    }


def score(evidence: dict) -> int:
    if evidence["python_files"] >= 20 and evidence["test_files"] >= 8:
        return 100
    if evidence["python_files"] >= 10 and evidence["test_files"] >= 4:
        return 75
    if evidence["python_files"] >= 5:
        return 50
    return 0


def main() -> int:
    evidence = collect_evidence()
    print(json.dumps({"evidence": evidence, "score": score(evidence)}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
