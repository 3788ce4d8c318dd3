"""Run a function on N ranks, each a fresh process, and collect what each
returns: the launcher of the tests, `chip_smoke.py` and
`tools/dryrun_multichip.py` (torchrun is the launcher of the CLIs).

    results = spawn(fn, 2, args=(cfg,), timeout=300)

fn(rank, world_size, init_method, *args) runs in a process started by the
`spawn` method (it imports fn's module afresh, so fn is a module-level
function of a module that does not import JAX), with one CPU thread unless
the caller asks for torch's default (threads=None: ranks on cards, whose
host work -- pinning a 142 MB batch -- runs on several threads).
Ranks meet at a `file://` init method in a fresh directory, so concurrent
launches never share a TCP port.

A rank that raises fails the launch at once with its traceback, and the
other ranks are killed: they would wait in a collective until its timeout.
A launch that outlives `timeout` is killed and raises TimeoutError.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence

import torch


def _run_rank(fn, rank, world_size, init_method, args, out_path, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        result = fn(rank, world_size, init_method, *args)
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, out_path)


def _traceback(out_path: str) -> str:
    err = out_path + ".err"
    if not os.path.exists(err):
        return "(no traceback)"
    with open(err) as f:
        return f.read()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def spawn(
    fn: Callable,
    world_size: int,
    args: Sequence[Any] = (),
    timeout: float = 600.0,
    workdir: Optional[str] = None,
    threads: Optional[int] = 1,
) -> List[Any]:
    """Run fn on world_size ranks; returns each rank's result in rank
    order.  workdir: where the init file and the results go (a fresh
    temporary directory by default, removed afterwards)."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="dan_ranks_") if own else workdir
    init_method = "file://" + os.path.join(os.path.abspath(workdir), "pg_init")
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world_size)]
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_run_rank,
                    args=(fn, r, world_size, init_method, tuple(args), outs[r], threads),
                    daemon=True)
        for r in range(world_size)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _stop(procs)
                raise RuntimeError("\n".join(
                    f"rank {r} exited with {codes[r]}:\n{_traceback(outs[r])}" for r in failed))
            if all(c == 0 for c in codes):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                _stop(procs)
                hung = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {hung} of {world_size} still ran after {timeout} s")
            wait([p.sentinel for p in procs if p.exitcode is None],
                               timeout=min(left, 1.0))
        return [torch.load(o, map_location="cpu", weights_only=False) for o in outs]
    finally:
        _stop(procs)
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
