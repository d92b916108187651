"""Run one function on every rank of a ``torch.distributed`` world on
this host, with a deadline.

    python -m jsvx_torch.shard.launch MODULE:FUNCTION RANK WORLD BACKEND \\
        INIT GROUP_TIMEOUT_S [ARG ...]

is one rank: it joins the group at ``INIT`` (``file://path`` or
``tcp://host:port``) through :func:`jsvx_torch.runtime.multihost.initialize`
with ``BACKEND`` and a collective timeout of ``GROUP_TIMEOUT_S`` seconds,
calls ``FUNCTION(rank, world, *ARGS)`` (the ARGs as strings) and leaves
the group.  :func:`run_ranks` starts the ranks of a world as processes,
with a fresh ``file://`` rendezvous (no port to race for), and waits for
them with a deadline: a rank that fails or a world that deadlocks raises,
and every rank still running is killed.  Several ranks may share one card
under gloo; NCCL needs a card per rank.
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import os
import subprocess
import sys
import time

#: the directory that holds the ``jsvx_torch`` package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_worlds = itertools.count()


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_ranks(target: str, world: int, workdir: str, *args,
              backend: str = "gloo", timeout_s: float = 120.0,
              group_timeout_s: float = 60.0, path=()) -> list[str]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks, each a
    process of this host, and return their standard outputs in rank
    order.

    The rendezvous file and each rank's output and error files go to
    ``workdir``.  ``path`` lists directories to put on the ranks'
    ``PYTHONPATH`` beside the one holding ``jsvx_torch`` (where
    ``target``'s module lives).  Raises ``RuntimeError`` with the end of
    the failing rank's error output as soon as a rank exits with another
    code than 0, or once ``timeout_s`` passes; the ranks still running
    are killed either way.
    """
    os.makedirs(workdir, exist_ok=True)
    tag = f"{os.getpid()}_{next(_worlds)}"
    rendezvous = os.path.join(workdir, f"rendezvous_{tag}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT, *path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        env.setdefault(var, "lo")                # ranks of one host
    logs = [(os.path.join(workdir, f"rank{r}_{tag}.out"),
             os.path.join(workdir, f"rank{r}_{tag}.err"))
            for r in range(world)]
    procs = []
    try:
        with contextlib.ExitStack() as files:
            for rank, (out, err) in enumerate(logs):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "jsvx_torch.shard.launch", target,
                     str(rank), str(world), backend, "file://" + rendezvous,
                     str(group_timeout_s), *map(str, args)],
                    stdout=files.enter_context(open(out, "w")),
                    stderr=files.enter_context(open(err, "w")), env=env))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                for rank, code in enumerate(codes):
                    if code not in (None, 0):
                        raise RuntimeError(
                            f"{target}: rank {rank} of {world} exited "
                            f"{code}:\n{_tail(logs[rank][1])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    waiting = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(
                        f"{target}: ranks {waiting} of {world} still "
                        f"running after {timeout_s} s:\n"
                        f"{_tail(logs[waiting[0]][1])}")
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    outs = []
    for out, _ in logs:
        with open(out) as f:
            outs.append(f.read())
    return outs


def main(argv: list[str] | None = None) -> None:
    import torch.distributed as dist

    from ..runtime.multihost import initialize

    target, rank, world, backend, init, group_timeout_s, *args = (
        sys.argv[1:] if argv is None else argv)
    rank, world = initialize(init, int(world), int(rank), backend=backend,
                             timeout_s=float(group_timeout_s))
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
