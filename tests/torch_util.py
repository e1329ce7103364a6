"""Helpers of the tests that hold the torch port against the JAX package."""

import contextlib
import importlib.util
import io
import logging
import re
import sys
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
