"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` (the path is the manifest's
``file``), a cell ``workloads/<cell>.json``, an entry point
``entries/<entry>.py`` and a per-layer metric ``metrics/<metric>.py``.
:func:`problems` lists where the manifest breaks the benchmark's naming
and size rules (the tests hold it to none).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def read_json(rel: str, root: str = ROOT) -> dict:
    """A JSON file by its path relative to ``root`` (or absolute)."""
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def workload_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "workloads", f"{name}.json")


def load_cell(name: str, root: str = ROOT, here: str = HERE) -> tuple:
    """(the manifest, the cell's entry in it, its workload file, its
    configuration file) of the checkout at ``root``."""
    m = load(os.path.join(root, "BENCHMARK.json"))
    cell_entry = cell(m, name)
    workload = read_json(workload_file(name, here))
    config = read_json(config_entry(m, cell_entry["config"])["file"], root)
    workload["gops_per_stream"] = gops_per_segment(workload, config)
    return m, cell_entry, workload, config


def gops_per_segment(workload: dict, config: dict) -> int:
    """The whole GOPs of the workload's segment (``segment.seconds`` at
    the configuration's frame rate)."""
    frames = float(workload["segment"]["seconds"]) * float(
        config["frame_rate_hz"])
    return max(1, round(frames / int(config["gop_size"])))


def load_module(kind: str, name: str, here: str = HERE):
    """``entries/<name>.py`` or ``metrics/<name>.py`` as a module (a name
    may hold dots, so the file is loaded by its path)."""
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"jsvbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    (with ``setup_s``), or with ``trace`` the per-layer ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def problems(m: dict, root: str = ROOT) -> list:
    """Where ``m`` breaks the benchmark's rules of names, keys and sizes."""
    out = []
    if set(m) != KEYS["top"]:
        out.append(f"top-level keys {sorted(m)}")
    if not isinstance(m.get("run_seconds"), int) or not \
            1 <= m["run_seconds"] <= 51:
        out.append("run_seconds")
    cmd = m.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)):
        out.append("command")
    for p in m.get("paths", []):
        if not re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) or \
                p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p}")
    seen = set()
    for group, kind in (("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        for e in m.get(group, []):
            allowed = KEYS[kind] | ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            if not KEYS[kind] <= set(e) <= allowed:
                out.append(f"{group} {e.get('name')}: keys {sorted(e)}")
            name = e.get("name", "")
            if not NAME.match(name):
                out.append(f"name {name!r}")
            tag = ("metric" if kind in ("end_to_end", "per_layer")
                   else group, name)
            if tag in seen:
                out.append(f"duplicate {tag}")
            seen.add(tag)
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"better of {name}")
            if "source" in e and kind != "config" and \
                    e["source"] not in SOURCES:
                out.append(f"source of {name}")
            for k in ("why", "layer"):
                if k in e and not _line(e[k]):
                    out.append(f"{k} of {name}")
    for c in m.get("configs", []):
        if not _line(c.get("source")):
            out.append(f"source of {c.get('name')}")
        if len(c.get("reduced", [])) > 16 or not all(
                NAME.match(k) for k in c.get("reduced", [])):
            out.append(f"reduced of {c.get('name')}")
        if not os.path.exists(os.path.join(root, c.get("file", ""))):
            out.append(f"file of {c.get('name')}")
    names = {c["name"] for c in m.get("configs", [])}
    for w in m.get("workloads", []):
        if w.get("config") not in names or w.get("chips") not in (1, 4):
            out.append(f"cell {w.get('name')}")
        if not NAME.match(w.get("traffic", "")) or not NAME.match(
                w.get("config", "")):
            out.append(f"traffic or config of {w.get('name')}")
    e2e = {e["name"] for e in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for e in m.get("end_to_end", []):
        if e.get("source") not in ("host_clock", "device_trace"):
            out.append(f"source of {e.get('name')}")
        if not 0.01 <= e.get("bound", 0) <= 0.25:
            out.append(f"bound of {e.get('name')}")
    for e in m.get("per_layer", []):
        if e.get("moves") not in e2e:
            out.append(f"moves of {e.get('name')}")
    return out
