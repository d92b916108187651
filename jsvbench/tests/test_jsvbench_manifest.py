"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name; a configuration, cells and a per-layer metric added as
files alone run without an edit to code."""

import json
import os
import re

from jsvbench import manifest
from jsvbench.tests.helpers import run_tiny, tiny_copy

M = manifest.load()
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|width|height|size)")


def test_manifest_keeps_the_rules():
    assert manifest.problems(M) == []
    assert M["command"] == ["python3", "jsvbench/run.py"]
    assert M["paths"] == ["jsvbench"]
    assert len(json.dumps(M)) < 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert manifest.NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert manifest.UNIT.match(e["unit"]), e["unit"]
    assert not manifest.problems({**M, "configs": M["configs"] + [
        {**M["configs"][0], "name": "has space"}]}) == []
    assert "unit 'tokens per s'" in manifest.problems({
        **M, "end_to_end": M["end_to_end"] + [
            {**M["end_to_end"][0], "name": "x", "unit": "tokens per s"}]})


def test_each_file_is_found_by_name():
    for c in M["configs"]:
        cfg = manifest.read_json(c["file"])
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"]
            assert not WIDTH.search(key)
    for w in M["workloads"]:
        wl = manifest.read_json(manifest.workload_file(w["name"]))
        assert wl["config"] == w["config"]
        assert wl["entry"] == w["traffic"]
        assert os.path.exists(os.path.join(manifest.HERE, "entries",
                                           wl["entry"] + ".py"))
        assert wl["checks"]["missing_frames"] == 0
    for e in M["per_layer"]:
        reader = manifest.load_module("metrics", e["name"])
        assert callable(reader.read)
        assert set(e["workloads"]) <= {w["name"] for w in M["workloads"]}


def test_every_cell_reports_setup_an_e2e_and_a_layer_metric():
    for w in M["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(M, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.metrics_of(M, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_cells_added_as_files_run_without_code_edits(tmp_path):
    root, here = tiny_copy(str(tmp_path))
    with open(os.path.join(here, "metrics", "playbacks.play.py"), "w") as f:
        f.write("def read(r):\n    return float(r.units['playbacks'])\n")
    m = manifest.load(os.path.join(root, "BENCHMARK.json"))
    m["per_layer"].append({"name": "playbacks.play", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "sink", "moves": "play_fps",
                           "workloads": ["tiny.play"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    assert manifest.problems(m, root) == []
    r = run_tiny(root, here, "tiny.transcode")
    assert r["correct"] and set(r["metrics"]) == {
        "transcode_fps", "setup_s"}
    r = run_tiny(root, here, "tiny.play", trace=True)
    assert r["correct"] and r["metrics"]["playbacks.play"]["value"] >= 1
