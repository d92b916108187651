"""Nothing the command loads is JAX or jsvx, by whole top-level names
(``jsvx_torch`` begins with ``jsvx``), and the reference, the generator
and the yardstick load nothing of the program."""

import ast
import os
import subprocess
import sys

from jsvbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "jsvx"}
#: the yardstick: no module of the program in any of these
PLAIN = ("reference", "encoder.py", "streams.py", "compare.py", "work.py",
         "manifest.py", "units.py", "control.py")

BLOCKER = """
import sys, importlib.abc
class Refuse(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = set(names)
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in self.names:
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, Refuse(sys.argv[1].split(',')))
"""


def sources(under=""):
    base = os.path.join(manifest.HERE, under)
    if base.endswith(".py"):
        yield base
        return
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_jsvx():
    for path in sources():
        assert not set(top_imports(path)) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for part in PLAIN:
        for path in sources(part):
            assert "jsvx_torch" not in set(top_imports(path)), path


def run_refusing(names, code):
    return subprocess.run(
        [sys.executable, "-c", BLOCKER + code, ",".join(names)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)


def test_what_the_command_loads_refusing_jax_and_jsvx():
    code = (
        "import runpy, sys\n"
        "sys.path.insert(0, '.')\n"
        "from jsvbench import harness, manifest\n"
        "m = manifest.load()\n"
        "for w in m['workloads']:\n"
        "    wl = manifest.read_json(manifest.workload_file(w['name']), '/')\n"
        "    manifest.load_module('entries', wl['entry'])\n"
        "for e in m['per_layer']:\n"
        "    manifest.load_module('metrics', e['name'])\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    r = run_refusing(sorted(FORBIDDEN), code)
    assert r.returncode == 0, r.stderr
    assert "'jsvx_torch'" in r.stdout
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "import jsvbench.reference.oracle, jsvbench.streams, "
            "jsvbench.compare, jsvbench.work, jsvbench.control\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    r = run_refusing(sorted(FORBIDDEN | {"jsvx_torch"}), code)
    assert r.returncode == 0, r.stderr


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jsvx_torch_fake", sys)
    assert harness.forbidden_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jsvx.api", sys)
    assert "jsvx" in harness.forbidden_modules()
