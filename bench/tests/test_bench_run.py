"""``run.py`` without a card: no result, a non-zero exit, never the CPU."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_prints_no_result():
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "appendix_c-2m.classify", "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no result" in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "correct" in obj)
