"""The process's pool of parse threads, and each parse's share of it.

The C++ parser releases the GIL while it parses a picture, so the
pictures of a GOP parse in parallel on threads.  One pool
(:data:`POOL`) serves every parse of the process: ``transcode``'s loops,
:func:`~jsvx_torch.pipeline.packed_parse.parse_gop_compact`,
:func:`~jsvx_torch.pipeline.packed_parse.parse_gop_packed`,
:func:`~jsvx_torch.pipeline.parallel_parse.parse_stream_parallel`, and
concurrent calls of them in threads of one process.  Its threads start
once, the first time a parse needs them, one for each CPU the process
may run on (``os.sched_getaffinity``), and no call shuts them down:
starting and joining a pool for every GOP cost a SIF GOP most of its
parse.  A task that raises fails the parse it belongs to; its thread
goes on to the next task.

A parse hands the pool a :class:`Batch`: its pictures in contiguous
chunks, one task a chunk, each chunk parsed in order inside its task.
The number of chunks follows the coded bytes (:func:`task_count`): a
small GOP gains nothing from more threads than its bytes keep busy, a
1080p GOP wants every core.  Tasks run in the order they were queued, so
a GOP queued before the next one is parsed first.
"""

from __future__ import annotations

import bisect
import os
import queue
import threading

#: coded bytes that one parse task takes on: a batch of ``b`` bytes is cut
#: into ``ceil(b / TASK_BYTES)`` tasks, at least one and at most the CPUs
#: and the pictures.  Calibrated on an H100 host of 8 CPUs (PERF.md
#: section 6): a Video CD GOP (86 KB) parses fastest in 2-3 tasks, a
#: 1080p GOP (1.07 MB) in 6-8
TASK_BYTES = 50_000


def cpus() -> int:
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def task_count(nbytes: int, n_items: int, cap: int) -> int:
    """Tasks for a batch of ``n_items`` pictures and ``nbytes`` coded
    bytes: ``ceil(nbytes / TASK_BYTES)``, clamped to [1, ``cap``] and to
    the pictures."""
    return max(1, min(-(-nbytes // TASK_BYTES), cap, n_items))


def chunks(sizes: list, k: int) -> list:
    """``k`` contiguous, non-empty ranges over ``range(len(sizes))``, each
    cut after the first item whose running sum of ``sizes`` reaches its
    share of the total."""
    n = len(sizes)
    run, total = [], 0
    for s in sizes:
        total += s
        run.append(total)
    cuts = [0]
    for j in range(1, k):
        i = bisect.bisect_left(run, j * total / k) + 1
        cuts.append(min(max(i, cuts[-1] + 1), n - (k - j)))
    cuts.append(n)
    return [range(a, b) for a, b in zip(cuts, cuts[1:])]


def picture_bytes(starts: list) -> list:
    """Each picture's coded bytes from the start bits of consecutive
    pictures; the last picture is taken as long as the one before it."""
    sizes = [(b - a) >> 3 for a, b in zip(starts, starts[1:])]
    return sizes + sizes[-1:] if sizes else [0] * len(starts)


class ParsePool:
    """Threads that run parse tasks in the order they were queued.

    The threads start at the first :meth:`put`, one for each CPU the
    process may then run on: ``workers`` of them (a forked child starts
    its own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks = None
        self.workers = 0

    def put(self, task) -> int:
        """Queue ``task()``; returns the threads this call started."""
        started = 0
        with self._lock:
            if self._tasks is None:
                self._tasks = queue.SimpleQueue()
                self.workers = cpus()
                for i in range(self.workers):
                    threading.Thread(target=_work, args=(self._tasks,),
                                     name=f"jsvx-parse-{i}",
                                     daemon=True).start()
                started = self.workers
            tasks = self._tasks
        tasks.put(task)
        return started

    def size(self) -> int:
        """The pool's threads: those it started, or will start."""
        return self.workers or cpus()

    def _forget(self) -> None:
        """In a forked child: the parent's threads are not there."""
        self._lock = threading.Lock()
        self._tasks = None
        self.workers = 0


def _work(tasks: queue.SimpleQueue) -> None:
    while True:
        tasks.get()()


#: the process's parse pool
POOL = ParsePool()
os.register_at_fork(after_in_child=POOL._forget)


class Lane:
    """One call's share of the pool, from the call's ``n_threads``: 1
    parses each batch serially on the calling thread (in :meth:`Batch.wait`);
    None cuts a batch by its bytes (:func:`task_count`, capped at the
    pool's threads); an int ``k`` cuts it likewise, capped at ``k``, and
    keeps at most ``k`` of the lane's tasks in flight (queueing waits for
    a slot).  ``threads_started`` counts the pool threads the lane's
    batches started."""

    def __init__(self, n_threads: int | None = None,
                 pool: ParsePool | None = None):
        if n_threads is not None and n_threads < 1:
            raise ValueError(f"n_threads must be None or >= 1, "
                             f"not {n_threads}")
        self.n_threads = n_threads
        self.pool = pool or POOL
        self.serial = n_threads == 1
        self._slots = (threading.BoundedSemaphore(n_threads)
                       if n_threads is not None and n_threads > 1 else None)
        self.threads_started = 0

    def submit(self, fn, sizes: list) -> "Batch":
        """Queue ``fn(i)`` for every item ``i`` of ``sizes`` (the items'
        coded bytes)."""
        n = len(sizes)
        if self.serial or n == 0:
            return Batch(fn, [range(n)] if n else [], queued=False)
        cap = self.pool.size() if self.n_threads is None else self.n_threads
        batch = Batch(fn, chunks(sizes, task_count(sum(sizes), n, cap)),
                      self._slots)
        for chunk in batch.chunks:
            if self._slots is not None:
                self._slots.acquire()
            self.threads_started += self.pool.put(
                lambda c=chunk: batch._run(c))
        return batch


class Batch:
    """The tasks of one parse (a GOP's pictures, or a stream's).
    ``tasks`` is their number.  A batch of a serial lane is not queued:
    :meth:`wait` parses it on the calling thread."""

    def __init__(self, fn, chunks: list, slots=None, queued: bool = True):
        self.fn, self.chunks, self.tasks = fn, chunks, len(chunks)
        self.queued = queued
        self._slots = slots
        self._left = len(chunks)
        self._error = None
        self._lock = threading.Lock()
        self._done = threading.Event()

    def _run(self, chunk: range) -> None:
        try:
            for i in chunk:
                self.fn(i)
        except Exception as e:          # raised again by wait()
            with self._lock:
                if self._error is None:
                    self._error = e
        finally:
            if self._slots is not None:
                self._slots.release()
            with self._lock:
                self._left -= 1
                if self._left == 0:
                    self._done.set()

    def join(self) -> None:
        """Wait until no task of the batch runs any more (its buffers are
        then the caller's again); raises nothing."""
        if self.queued:
            self._done.wait()

    def wait(self) -> None:
        """Parse or wait for every item; raises the first error a task
        raised, once every task has ended."""
        if not self.queued:
            for chunk in self.chunks:
                for i in chunk:
                    self.fn(i)
            return
        self._done.wait()
        if self._error is not None:
            raise self._error
