"""A short cell on the card, traced: run with ``python3 -m pytest
jsvbench/tests/test_jsvbench_cuda.py -m cuda`` on a machine with one."""

import json
import subprocess
import sys

import pytest

from jsvbench import manifest


@pytest.mark.cuda
def test_a_short_traced_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "jsvbench/run.py", "--workload",
         "vcd-sif.transcode", "--seed", "7", "--seconds", "2", "--trace",
         "1"], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for name in ("fused_roofline.transcode", "expand_roofline.transcode"):
        assert 0 < res["metrics"][name]["value"] <= 100
    assert len(res["breakdown"]["device_ops"]) <= 10
