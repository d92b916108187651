"""One run of one cell: set-up, the measured window, the check, the result.

``main`` checks for the card, then :func:`run_cell` does the rest:

1. the cell's workload file, its configuration and its entry point, all
   found by name (:mod:`jsvbench.manifest`);
2. the seed's stream (:mod:`jsvbench.streams`, cached in the checkout);
3. the entry's set-up: the program built or loaded from the checkout's
   build cache, and a short unit of this cell's work to warm every shape
   and GOP program it uses.  ``setup_s`` runs from the process's start to
   here, less the seconds spent encoding the seed's stream on its first
   run in a checkout (the user's input, reported as ``generate_s``);
4. the window: units until ``--seconds`` have passed, traced with
   ``--trace 1`` (:class:`jsvbench.work.Window`);
5. after the window: the card's peak memory, the sampled outputs copied
   to the host and the program's state freed, then the plain reference
   (cached per seed) and the comparison (:mod:`jsvbench.compare`);
6. the result: the checks on standard error as its last lines, and one
   JSON line on standard output, with the checks under ``checks``, last.

Nothing here, nor in anything it loads, may bring in ``jax``,
``jaxlib``, ``flax`` or ``jsvx``: the run ends without a result if
``sys.modules`` holds one of them once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from . import compare, manifest, streams
from .reference import oracle, tables as T
from .reference.container import find_start_codes
from .work import Window, gop_bounds

FORBIDDEN = ("jax", "jaxlib", "flax", "jsvx")
#: the warm-up's stream: each of the seed's distinct GOPs this many times,
#: so the set-up runs every shape and GOP program the window runs (a key's
#: first sight and a replay) in a fraction of a unit's time
WARM_ROUNDS = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def gops_of(data: bytes) -> list:
    """Each GOP's bytes, from its sequence header to the next one's."""
    codes = find_start_codes(data)
    starts = [int(o) for o, c in codes if c == T.START_SEQUENCE]
    return [data[a:b] for a, b in zip(starts, starts[1:] + [len(data)])]


def decode_key(gop: bytes) -> bytes:
    """A GOP's bytes with its GOP header's timecode cleared: what the
    decode depends on."""
    codes = find_start_codes(gop)
    at = next(int(o) for o, c in codes if c == T.START_GOP)
    return gop[:at + 4] + bytes(4) + gop[at + 8:]


class Reference:
    """The reference's decode of the sampled GOPs (one per distinct
    decode key: a stream repeats its seed's distinct GOPs in turn), and
    the work bounds of its pictures."""

    def __init__(self, store: streams.Streams, seed: int, data: bytes,
                 config: dict):
        self.gops = gops_of(data)
        self.store, self.seed, self.config = store, seed, config
        self.decoded: dict = {}
        self.seconds = 0.0

    def _decode(self, gop: bytes) -> tuple:
        fts = []
        planes = oracle.decode_gop(gop, keep=fts)
        c = self.config
        return planes, gop_bounds(fts, -(-int(c["height"]) // 16),
                                  -(-int(c["width"]) // 16),
                                  (int(c["height"]), int(c["width"])))

    def _of(self, g: int) -> tuple:
        key = decode_key(self.gops[g])
        if key not in self.decoded:
            got, spent = self.store.reference(self.seed, key, self._decode)
            self.seconds += spent
            self.decoded[key] = got
        return self.decoded[key]

    def of_gop(self, g: int) -> list:
        """The reference's planes of GOP ``g``, one tuple a picture."""
        return self._of(g)[0]

    def work(self) -> dict:
        """The work bounds of a GOP, the mean over the stream's GOPs (a
        window runs whole streams)."""
        total: dict = {}
        for g in range(len(self.gops)):
            for k, v in self._of(g)[1].items():
                total[k] = total.get(k, 0) + v
        return {k: v / len(self.gops) for k, v in total.items()}


def want_of(workload: dict, config: dict, frames_of,
            rgb=compare.reference_rgb):
    """The reference's answer for each sample key of this cell."""
    display = (int(config["height"]), int(config["width"]))
    return lambda key: compare.want(workload["output"], frames_of, key,
                                    int(config["gop_size"]), display, rgb)


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Host:
    """What the host did in the window: the process's CPU seconds (every
    thread), the garbage collector's passes and seconds, and the 1-minute
    load average at the start and the end."""

    def __enter__(self):
        self.gc_s, self.gc_passes, self._gc_t0 = 0.0, 0, None
        gc.callbacks.append(self._gc)
        self.load = [os.getloadavg()[0]]
        self.t0, self.cpu0 = time.perf_counter(), os.times()
        return self

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_passes += 1

    def __exit__(self, *exc) -> None:
        cpu = os.times()
        self.wall_s = time.perf_counter() - self.t0
        gc.callbacks.remove(self._gc)
        self.cpu_s = (cpu.user - self.cpu0.user
                      + cpu.system - self.cpu0.system)
        self.load.append(os.getloadavg()[0])

    def notes(self) -> dict:
        return dict(cpu_s=self.cpu_s, wall_s=self.wall_s, gc_s=self.gc_s,
                    gc_passes=self.gc_passes, loadavg_1m=self.load)


class Record:
    """What the per-layer readers read: the program's stage sums over the
    window, the window's units, the trace, the work bounds and the
    harness's own sink timings (``clock``: the entry's rates and tails
    on the host clock, by their end-to-end names)."""

    def __init__(self, entry, window: Window, bounds: dict,
                 window_s: float):
        self.stages = entry.stages
        self.units = entry.units
        self.sink = entry.sink_s
        self.clock = entry.end_to_end(window_s)
        self.window = window
        self.bounds = bounds

    def per(self, stage_names, unit: str, scale: float = 1e3):
        n = self.units.get(unit, 0)
        if not n or not any(s in self.stages for s in stage_names):
            return None
        return scale * sum(self.stages.get(s, 0.0)
                           for s in stage_names) / n

    def roofline(self, fragment: str, bound_s: float, launches: int):
        """100 x the bound of the work over the kernel's device time, when
        the trace holds exactly the launches the work implies."""
        t, n = self.window.kernel(fragment)
        if not t or n != launches:
            return None
        return 100.0 * bound_s / t


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, root: str = manifest.ROOT,
             here: str = manifest.HERE, cache_dir: str | None = None,
             out=sys.stdout, err=sys.stderr) -> dict | None:
    """The whole run on ``device``; returns the result printed (None when
    the run may print none)."""
    import torch

    m, cell, workload, config = manifest.load_cell(cell_name, root, here)
    entry_mod = manifest.load_module("entries", workload["entry"], here)
    store = streams.Streams(cell["config"], config,
                            cache_dir or streams.CACHE_DIR)
    data, gen_s = store.stream(seed, int(workload["gops_per_stream"]))
    warm, _ = store.stream(seed, WARM_ROUNDS * int(config["distinct_gops"]))

    cuda = torch.device(device).type == "cuda"
    window = Window(trace, cuda)
    entry = entry_mod.Entry(workload, config, device, window, seed)
    entry.set_up(data, warm)
    setup_s = time.perf_counter() - t0 - gen_s

    with window.run(), Host() as host:
        window_s = entry.measure(seconds)

    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    samples = entry.samples()
    entry.close()

    ref = Reference(store, seed, data, config)
    found = compare.numbers(samples, want_of(workload, config, ref.of_gop),
                            entry.missing)
    correct, checks = compare.judge(found, workload["checks"])

    metrics = {}
    wanted = manifest.metrics_of(m, cell_name, trace)
    if trace:
        record = Record(entry, window, ref.work(), window_s)
        for spec in wanted:
            if spec["source"] == "device_trace" and not cuda:
                continue            # a CPU run writes no device metric
            reader = manifest.load_module("metrics", spec["name"], here)
            value = reader.read(record)
            if value is not None:
                metrics[spec["name"]] = {"value": value,
                                         "unit": spec["unit"]}
    else:
        e2e = entry.end_to_end(window_s)
        e2e["setup_s"] = setup_s
        for spec in wanted:
            if spec["name"] in e2e:
                metrics[spec["name"]] = {"value": e2e[spec["name"]],
                                         "unit": spec["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"jsvbench: the run loaded {', '.join(bad)}", file=err)
        return None

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace and cuda:
        dev["busy_s"] = window.busy_s
        dev["window_s"] = window.window_s
    result = {"correct": correct, "attempted": entry.attempted,
              "failed": entry.failed, "metrics": metrics, "device": dev}
    if trace and cuda:
        result["breakdown"] = window.breakdown()
    result["notes"] = {"card": card_limit() if cuda else "cpu",
                       "generate_s": gen_s, "reference_s": ref.seconds,
                       "window_s": window_s, "host": host.notes(),
                       "units": entry.units,
                       "stages_s": entry.stages,
                       "counters": entry.counters,
                       "max_abs_diff": found["max_abs_diff"]}
    if trace and cuda:
        result["notes"]["launches"] = {n: k for n, (_, k)
                                       in window.kernels.items()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=err)
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"jsvbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0)
    return 0 if result is not None else 4
