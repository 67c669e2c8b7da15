"""Smoke test for the driver's benchmark entry point (tiny shapes, CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_bench_emits_incremental_json_lines():
    env = dict(os.environ)
    env.update(
        DEWI_BENCH_N_DOCS="3000",
        DEWI_BENCH_DIM="32",
        DEWI_BENCH_N_QUERIES="16",
        DEWI_BENCH_REPS="3",
        DEWI_BENCH_PLATFORM="cpu",
    )
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        capture_output=True, text=True, timeout=480, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    # Emission protocol: the line is REPRINTED after every
    # completed section so a timeout can never erase the run; every line
    # must parse and the LAST is authoritative.
    assert len(lines) >= 1
    for line in lines:
        json.loads(line)
    record = json.loads(lines[-1])
    # Each successive emission only accumulates sections.
    if len(lines) > 1:
        prev = json.loads(lines[0])["extras"]["section_seconds"]
        last = record["extras"]["section_seconds"]
        assert set(prev) <= set(last)
    assert record["metric"] == "p50_query_latency_1M_docs_k10"
    assert record["value"] > 0
    assert "vs_baseline" in record and "unit" in record
    # Headline selection takes the FASTEST tier meeting the >=0.99 recall
    # gate; on tiny CPU shapes f32 vs bf16 timing flips run to run, so
    # assert the gate rather than a specific tier's recall.
    assert record["extras"]["recall_vs_exact"] >= 0.99
    assert 0.0 < record["extras"]["bf16_recall_vs_f32_at_k10"] <= 1.0
