"""Each entry point at a tiny size on the CPU, held to the reference,
with no device metric written; and a run without a card prints no
result."""

import os
import shutil
import subprocess
import sys

import pytest

from jsvbench import manifest
from jsvbench.tests.helpers import run_tiny, tiny_copy

DEVICE_METRICS = {m["name"] for m in manifest.load()["per_layer"]
                  if m["source"] == "device_trace"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", ["tiny.transcode", "tiny.play"])
@pytest.mark.parametrize("trace", [False, True])
def test_entry_on_the_cpu(tiny, cell, trace):
    r = run_tiny(*tiny, cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    assert "busy_s" not in r["device"] and "breakdown" not in r
    assert not set(r["metrics"]) & DEVICE_METRICS
    assert list(r)[-1] == "checks"
    if trace:
        assert r["metrics"], r
    else:
        assert r["metrics"]["setup_s"]["value"] > 0
        assert set(r["metrics"]) == {
            m["name"] for m in manifest.metrics_of(manifest.load(
                os.path.join(tiny[0], "BENCHMARK.json")), cell, False)}


def test_no_card_no_result(tmp_path):
    """The command without a card (as here), and in a directory that holds
    only BENCHMARK.json and jsvbench/: an error, nothing on stdout."""
    for cwd in (manifest.ROOT, str(tmp_path)):
        if cwd != manifest.ROOT:
            shutil.copytree(manifest.HERE, os.path.join(cwd, "jsvbench"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(manifest.MANIFEST, cwd)
        r = subprocess.run(
            [sys.executable, "jsvbench/run.py", "--workload",
             "vcd-sif.transcode", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0 and r.stdout == "", r.stdout
