"""Helpers of the tests that hold the torch port against the JAX package."""

import contextlib
import importlib.util
import io
import logging
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# The default test run puts 6 pytest-xdist workers on the host's cores,
# each beside XLA's own threads; torch's default of one intra-op thread a
# core in every worker oversubscribes them many times over. Every
# tests/test_torch_*.py imports this module, so the cap holds in any worker
# that runs one of them.
DEFAULT_THREADS = torch.get_num_threads()
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def default_threads():
    """torch's own intra-op thread count (one a core) inside the block.
    A few parity tests compare LM stop decisions at the float64 floor,
    where the cost moves by ulps; those move with the CPU BLAS's summation
    order, and that order with the thread count."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(TORCH_THREADS)


def rel_err(a, b):
    """max |a - b| / max |b|, on numpy copies of tensors or arrays."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def peak_set(scores, rows, cols, ndigits=9):
    """The valid peaks of a top_k_peaks result as a set of (row, col,
    score rounded to ndigits): ties among equal scores may come in any
    order, so peaks compare as sets."""
    s = np.asarray(scores.cpu() if isinstance(scores, torch.Tensor)
                   else scores)
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows)
    c = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor) else cols)
    return {(int(a), int(b), round(float(v), ndigits))
            for a, b, v in zip(r, c, s) if np.isfinite(v)}


class RecordCollector(logging.Handler):
    """A logging handler that keeps the records it is given."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def collect_records(logger_name):
    """The records the named logger emits inside the block, at INFO and
    above, collected by a handler of the test's own (loggers are global by
    name: both packages' examples log to the same object). Yields the
    list."""
    log = logging.getLogger(logger_name)
    handler = RecordCollector()
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield handler.records
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def run_jax_example(name, argv, logger_name=None):
    """examples/<name>.py (the JAX package's example) loaded by file path
    and its main() run in this process with sys.argv = [<file>, *argv]:
    (the args of each record its logger emitted, its stdout). The JAX
    matmul precision it sets is restored after."""
    import jax

    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    precision = jax.config.jax_default_matmul_precision
    argv_before, out = sys.argv, io.StringIO()
    sys.argv = [str(path), *argv]
    try:
        with collect_records(logger_name or name) as records, \
                contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv_before
        jax.config.update("jax_default_matmul_precision", precision)
    return [r.args for r in records], out.getvalue()


def run_port_example(module, argv, logger_name=None):
    """The port's example `module`'s main(argv): (its returned dict, the
    args of each record its logger emitted, its stdout)."""
    out = io.StringIO()
    name = module.__name__.rsplit(".", 1)[1]
    with collect_records(logger_name or name) as records, \
            contextlib.redirect_stdout(out):
        result = module.main(argv)
    return result, [r.args for r in records], out.getvalue()


def printed_numbers(text):
    """Every number in `text`, in order, as floats."""
    return [float(v) for v in re.findall(
        r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", text)]


# ---- ranks of a gloo process group on the CPU (the distributed solvers) ----

def spawn_ranks(fn, world_size, workdir, *args, timeout=300.0):
    """fn(rank, world_size, *args) in world_size spawned processes joined
    by a gloo process group through a ``file://`` store in `workdir` (no
    port: parallel test workers never collide), one intra-op thread each.
    Returns each rank's result, in rank order. Raises if a rank fails, or
    hangs past `timeout` seconds (its processes are killed then)."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, rank, world_size, str(workdir), args))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(workdir / f"rank{rank}.err").read_text()
              for rank in range(world_size)
              if (workdir / f"rank{rank}.err").exists()]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks hung: {hung}; exit codes "
                             f"{[p.exitcode for p in procs]}\n"
                             + "\n".join(errors))
    return [torch.load(workdir / f"rank{rank}.pt", weights_only=False)
            for rank in range(world_size)]


def _rank_entry(fn, rank, world_size, workdir, args):
    import traceback

    import torch.distributed as dist

    from slam_tricks_tpu_torch.parallel.multihost import initialize_multihost

    torch.set_num_threads(TORCH_THREADS)
    initialize_multihost(f"file://{workdir}/store", world_size, rank,
                         timeout_s=120.0)
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, f"{workdir}/rank{rank}.pt")
    except BaseException:
        Path(f"{workdir}/rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def count_all_reduce():
    """Records each ``torch.distributed.all_reduce`` call's operand inside
    the block as (numel, bytes). Yields the list."""
    import torch.distributed as dist

    calls = []
    inner = dist.all_reduce

    def wrapped(tensor, *a, **kw):
        calls.append((tensor.numel(), tensor.numel() * tensor.element_size()))
        return inner(tensor, *a, **kw)

    dist.all_reduce = wrapped
    try:
        yield calls
    finally:
        dist.all_reduce = inner


def solve_cases(rank, world_size, cases):
    """The distributed solvers' rank job: for each (key, make, kwargs,
    args, flags) of `cases`, solve = make(group, **kwargs) and
    solve(*args, costs=...), group the world, or with flags "self" this
    rank alone (a group of size 1); with flags "count" the all_reduce
    operands are recorded. Returns {key: (BAState on the CPU, costs,
    all_reduce records)}."""
    import torch.distributed as dist

    selves = [dist.new_group([r]) for r in range(world_size)]
    out = {}
    for key, make, kwargs, args, flags in cases:
        group = selves[rank] if "self" in flags else dist.group.WORLD
        if "self" in flags and rank != 0:
            continue
        costs = []
        with count_all_reduce() as calls:
            state = make(group, **kwargs)(*args, costs=costs)
        out[key] = (state._replace(
            poses=type(state.poses)(state.poses.R.cpu(), state.poses.t.cpu()),
            points=state.points.cpu(), cost=state.cost.cpu(),
            lam=state.lam.cpu(), nu=state.nu.cpu()),
            [float(c) for c in costs], calls if "count" in flags else None)
    return out
