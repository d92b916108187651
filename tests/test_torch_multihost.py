"""The port's process bootstrap (``runtime.multihost.initialize``), the GOP
manifest split across processes, and ``tools/bench_scaling.py``, on the
CPU.

Ranks are processes started by ``jsvx_torch.shard.launch.run_ranks``
(gloo, a ``file://`` rendezvous in ``tmp_path``, a deadline); their bodies
are in ``tests/torch_shard_worker.py``, which imports ``jsvx_torch`` only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import decode_stream_oracle
from jsvx_torch.runtime.multihost import initialize
from jsvx_torch.shard.launch import run_ranks

from conftest import synthetic_frames

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _clip_stream(tmp_path):
    """9 frames of 48x64 in 3 GOPs (tests/test_multihost.py's stream)."""
    clip = synthetic_frames(9, 48, 64, seed=61)
    data = JsvEncoder(64, 48, EncoderConfig(
        gop_size=3, quantizer_scale=4)).encode(clip)
    path = tmp_path / "clip.jsv"
    path.write_bytes(data)
    return data, str(path)


def test_initialize_alone_returns_0_1_and_starts_nothing(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() == (0, 1)
    assert not dist.is_initialized()


def test_two_gloo_processes_initialize(tmp_path):
    outs = run_ranks("torch_shard_worker:report", 2, str(tmp_path),
                     timeout_s=120, path=[TESTS])
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for i, r in enumerate(got):
        assert (r["rank"], r["world"]) == (i, 2)
        assert (r["group_rank"], r["group_world"]) == (i, 2)
        assert r["backend"] == "gloo"
    assert not any(n.startswith("rendezvous_") for n in os.listdir(tmp_path))


def test_two_process_gop_distribution(tmp_path):
    """tests/test_multihost.py's manifest split on the port: two ranks
    each transcode their round-robin share on the CPU; the union of their
    per-GOP plane sums equals one process's and the float64 oracle's."""
    data, path = _clip_stream(tmp_path)
    outs = run_ranks("torch_shard_worker:transcode_share", 2, str(tmp_path),
                     path, str(tmp_path), timeout_s=240, path=[TESTS])
    results = {}
    for o in outs:
        r = json.loads(o.strip().splitlines()[-1])
        results[r["pid"]] = r
    # rank 0 gets GOPs 0 and 2, rank 1 GOP 1; the union covers all 9
    assert results[0]["gops"] == 2 and results[1]["gops"] == 1
    assert results[0]["frames"] + results[1]["frames"] == 9
    assert results[0]["done"] == [0, 2] and results[1]["done"] == [1]
    got = {int(k): v for r in results.values() for k, v in r["sums"].items()}
    assert set(got) == {0, 1, 2}

    from jsvx_torch.pipeline.transcode import transcode

    one = {}
    transcode(data, lambda gi, o: one.__setitem__(
        gi, [int(p.to(torch.int64).sum()) for p in o]), device="cpu")
    assert got == one
    frames = decode_stream_oracle(data)
    for gi in range(3):
        fs = frames[gi * 3:(gi + 1) * 3]
        want = [int(sum(f.planes[c].astype(np.int64).sum() for f in fs))
                for c in range(3)]
        assert got[gi] == want, f"GOP {gi} mismatch"


def test_bench_scaling_runs_two_cpu_processes(tmp_path):
    _, path = _clip_stream(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "jsvx_torch.tools.bench_scaling", "2", path,
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["metric"] == "multiprocess_scaling_efficiency"
    assert r["device"] == "cpu" and r["frames"] == 9
    for k in ("one_proc_seconds", "2_proc_max_seconds",
              "one_proc_1core_seconds", "2_proc_1core_each_max_seconds",
              "efficiency_shared_cores", "efficiency_private_cores",
              "one_proc_frames_per_s", "2_proc_frames_per_s"):
        assert r[k] > 0, k
