"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process a source,
all started together, and links the objects into one shared library with a
plain C interface, ``build/kernels/libslam_kernels_<hash>.so`` at the root
of the checkout, at the first call of ``library()``. The hash
covers the sources, the headers they share (``csrc/*.cuh``) and the flags,
so an edited source builds anew. The
library is loaded with ``ctypes``; each C entry point takes its pointers and
the CUDA stream as ``void*`` and returns ``cudaGetLastError()`` after its
launch, which the wrappers turn into an exception.

Importing this module needs neither CUDA nor ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SMEM_PER_BLOCK = 232448   # bytes of shared memory a Hopper block can use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# ba_assemble (width 6) and ba_assemble9: R_flat, t, intr (NULL at width
#   6), points, uv0, uv1, w, cam_of_slot, slots, seg_cam, seg_start, n_seg,
#   C, K, L, landmark row stride, accumulate, loss kind, loss param, its
#   square, Hpp, gp, Hll, gl, W, cost, scratch, device, stream
_BA = [_P] * 11 + [_I] * 7 + [_D, _D] + [_P] * 7 + [_I, _P]
# spd_solve and spd_solve_blocked: S, b, A (scratch), yz (scratch), x,
#   flags (scratch), n, stream
_SPD = [_P] * 6 + [_I, _P]
# tridiag_solve: D, E, r, store, lev (scratch), work (tile scratch or NULL),
#                x, G, m, q, stream
_TRI = [_P] * 7 + [_I, _I, _I, _P]


def _undistort(scalar):
    """undistort: px, out, n (64-bit), fx, fy, cx, cy, k1, k2, k3, p1, p2,
    iters, device, stream"""
    return [_P, _P, ctypes.c_int64] + [scalar] * 9 + [_I, _I, _P]


SIGNATURES = {
    "ba_assemble_f32": _BA, "ba_assemble_f64": _BA,
    "ba_assemble9_f32": _BA, "ba_assemble9_f64": _BA,
    "spd_solve_f32": _SPD, "spd_solve_f64": _SPD,
    "spd_solve_blocked_f32": _SPD, "spd_solve_blocked_f64": _SPD,
    "tridiag_solve_f32": _TRI, "tridiag_solve_f64": _TRI,
    "undistort_f32": _undistort(ctypes.c_float),
    "undistort_f64": _undistort(ctypes.c_double),
}

_lib = None


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are compiled at their first launch")


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def library():
    """The loaded kernel library, built first if it is not on disk."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = Path(tmpdir)
            sources = sorted(CSRC.glob("*.cu"))
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for src in sources]
            logs = [(p.communicate()[0], p.returncode) for p in procs]
            if all(rc == 0 for _, rc in logs):
                link = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / so.name),
                     *(str(tmp / f"{src.stem}.o") for src in sources)],
                    capture_output=True, text=True)
                logs.append((link.stdout + link.stderr, link.returncode))
            for log, rc in logs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
            os.replace(tmp / so.name, so)   # atomic: a loader never sees half
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc, name):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
