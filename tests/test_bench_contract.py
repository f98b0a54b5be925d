"""Driver-contract smoke tests: bench JSON schema and entry importability."""
import json
import os
import subprocess
import sys

import pytest


def test_bench_emits_json_line():
    env = dict(os.environ, NINPOL_BENCH_N="4", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, timeout=900)
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert lines, out.stderr[-2000:]
    rec = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec
    assert rec["unit"] == "Mnodes/s"
    assert rec["max_rel_err"] < 1e-10
    # every record names the device it ran on
    dev = rec["device"]
    assert (dev["platform"], dev["count"]) == ("cpu", 8)
    assert dev["kind"] and "card" in dev and "xla_flags" in dev
    assert dev["kind"] in rec["metric"]


def test_graft_entry_importable():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge
    assert callable(ge.entry)
    assert callable(ge.dryrun_multichip)
