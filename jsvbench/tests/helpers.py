"""A copy of the benchmark with a tiny configuration and cells added as
data files only, for runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import time

from jsvbench import manifest

TINY = {"name": "tiny", "source": "a test size", "width": 128,
        "height": 96, "coded_width": 128, "coded_height": 96,
        "rate_code": 4, "frame_rate_hz": 29.97, "bytes_per_picture": 1200,
        "gop_size": 4, "distinct_gops": 2,
        "generator": {"quantizer_scale": 8, "noise": 2.0, "f_code": 3}}


def tiny_copy(tmp: str) -> tuple[str, str]:
    """(root, package dir) of a copy of ``BENCHMARK.json`` and
    ``jsvbench/`` with the configuration ``tiny`` and the cells
    ``tiny.transcode`` and ``tiny.play`` added as files."""
    root = os.path.join(tmp, "checkout")
    here = os.path.join(root, "jsvbench")
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load()
    with open(os.path.join(here, "configs", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    m["configs"].append({"name": "tiny", "source": "a test size",
                         "file": "jsvbench/configs/tiny.json",
                         "reduced": [], "why": "tests"})
    for entry, like in (("transcode", "vcd-sif.transcode"),
                        ("play", "atsc1080.play")):
        name = f"tiny.{entry}"
        w = manifest.read_json(manifest.workload_file(like))
        w.update(config="tiny", segment={"seconds": 0.4, "source": "tests"})
        with open(os.path.join(here, "workloads", f"{name}.json"), "w") as f:
            json.dump(w, f)
        m["workloads"].append({"name": name, "config": "tiny",
                               "traffic": entry, "chips": 1,
                               "why": "tests"})
        for e in m["end_to_end"] + m["per_layer"]:
            if like in e.get("workloads", []):
                e["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return root, here


def run_tiny(root: str, here: str, cell: str, trace: bool = False,
             seed: int = 5, seconds: float = 0.2) -> dict:
    """One run of ``cell`` of the copy on the CPU (the look for a card
    skipped); returns its result."""
    from jsvbench.harness import run_cell

    with open(os.devnull, "w") as quiet:
        return run_cell(cell, seed, seconds, trace, "cpu",
                        time.perf_counter(), root=root, here=here,
                        cache_dir=os.path.join(root, "cache"), out=quiet,
                        err=quiet)
