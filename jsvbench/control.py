"""The control of a cell's check: the plain reference put in the
program's place, computed one precision below the configuration's.

The configurations state a float32 reconstruction with TF32 off, so the
control is the reference's decode of the same GOP bytes with its IDCT as
two TF32 matrix products (``oracle.idct_plane_tf32``) and, for RGB
output, its colour matrix product in TF32 too.  Its outputs stand in for
the timed path's samples (``sample_gops`` GOPs, or ``sample_frames``
frames drawn from the seed) and go through the cell's own comparison and
limits: the check has to come out not correct.

    python3 jsvbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the compared numbers and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

if __package__ in (None, ""):
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != os.path.dirname(
                       os.path.abspath(__file__))]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from jsvbench import compare, manifest, streams  # noqa: E402
from jsvbench.harness import Reference, decode_key, want_of  # noqa: E402
from jsvbench.reference import oracle  # noqa: E402


def control_numbers(cell_name: str, seed: int, root: str = manifest.ROOT,
                    here: str = manifest.HERE,
                    cache_dir: str | None = None) -> dict:
    """The control's compared numbers and verdict for one seed."""
    _, cell, workload, config = manifest.load_cell(cell_name, root, here)
    store = streams.Streams(cell["config"], config,
                            cache_dir or streams.CACHE_DIR)
    gops = int(workload["gops_per_stream"])
    data, _ = store.stream(seed, gops)
    ref = Reference(store, seed, data, config)
    memo: dict = {}

    def control_of(g: int) -> list:
        key = decode_key(ref.gops[g])
        if key not in memo:
            memo[key] = oracle.decode_gop(key, idct=oracle.idct_plane_tf32)
        return memo[key]

    rng = random.Random(seed)
    gop_size = int(config["gop_size"])
    if workload["output"] == "planes":
        keys = [rng.randrange(gops) for _ in range(workload["sample_gops"])]
        rgb = compare.reference_rgb
    else:
        keys = [rng.randrange(gops * gop_size)
                for _ in range(workload["sample_frames"])]
        rgb = compare.reference_rgb_tf32
    got = want_of(workload, config, control_of, rgb)
    samples = [(k, got(k)) for k in keys]
    found = compare.numbers(samples, want_of(workload, config, ref.of_gop),
                            missing=0)
    correct, checks = compare.judge(found, workload["checks"])
    return {"cell": cell_name, "seed": seed, "correct": correct,
            "numbers": found, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(control_numbers(args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
