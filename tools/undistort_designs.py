"""Time design candidates of the undistort kernel on one CUDA device.

    python3 tools/undistort_designs.py [--parent FILE] [--out DIR]

Builds variants of ``slam_tricks_tpu_torch/csrc/undistort.cu`` that differ
only in its design constants (``DESIGNS``): pixels a thread (1: one 8-byte
pixel, 2: one 16-byte vector, 4: two, and so on) and threads a block, plus
the source as it is with normalization by one fused multiply-add. With
--parent FILE it also builds an earlier version of the source (entry
points with a 32-bit count and no device argument). Every variant is its
own shared library, all compiled at once.

Each variant undistorts the 8,388,608 float32 pixels of the st1 path
(5 Newton steps) and is held against ``ops/undistort.undistort_plain``
(max |k - p| px), and on a view 8 mod 16 bytes of 3,001 pixels. Times, in
ms a call, median over rounds that take the variants in turn: ``ms`` back
to back (an output allocated a call, as the wrapper does) and ``device_ms``
queued behind a head start of matrix products (the card alone), as
``chip_smoke.py`` times them. Prints a table and the card's name and power
limit; with --out DIR writes designs.json there. Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "slam_tricks_tpu_torch" / "csrc" / "undistort.cu"
BUILD = ROOT / "build" / "undistort_designs"
PARAMS = (458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.0,
          0.00019359, 1.76187114e-05)
NPX = 8_388_608
ROUNDS = 3              # rounds of timing, each over every variant in turn
_VEC_FLOAT = ("struct Vec<float> { using type = float4; "
              "static constexpr int kPix = 2; };")
_NORMALIZE = ("u0[p] = u[p] = (x[p] - c.cx) * c.rfx;",
              "v0[p] = v[p] = (y[p] - c.cy) * c.rfy;")


def _const(text, name, value):
    text, k = re.subn(rf"constexpr int {name} = [^;]+;",
                      f"constexpr int {name} = {value};", text)
    if k != 1:
        raise SystemExit(f"undistort_designs: no constant {name} in source")
    return text


def _replace(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"undistort_designs: {old!r} not once in source")
    return text.replace(old, new)


# (pixels a thread, threads a block): the candidates timed
DESIGNS = [(1, 256), (2, 256), (4, 128), (4, 256), (8, 128), (8, 256),
           (8, 512), (16, 128), (16, 256)]


def variants():
    """{name: source text} of every candidate."""
    base = SOURCE.read_text()
    out = {}
    for pix, threads in DESIGNS:
        s = _const(base, "kThreads", threads)
        s = _const(s, "kVecs", max(1, pix // 2))
        if pix == 1:
            s = _replace(s, _VEC_FLOAT, _VEC_FLOAT.replace(
                "float4", "float2").replace("kPix = 2", "kPix = 1"))
        out[f"{pix} px, {threads} threads"] = s
    s = _replace(base, _NORMALIZE[0],
                 "u0[p] = u[p] = fma_(x[p], c.rfx, -c.cx * c.rfx);")
    out["shipped, normalized by one FFMA"] = _replace(
        s, _NORMALIZE[1], "v0[p] = v[p] = fma_(y[p], c.rfy, -c.cy * c.rfy);")
    return out


def build(sources, nvcc, flags):
    """Compile each source into its own library, all at once; returns
    {name: (library path, f32 kernel's registers)}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = BUILD / f"v{i}.cu"
        if isinstance(text, Path):
            src = text
        else:
            src.write_text(text)
        so = BUILD / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-shared", "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"undistort_designs: {name}: nvcc failed:\n{log}")
        regs, func = None, ""
        for line in log.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                func = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and "IfE" in func:
                regs = int(m.group(1))
        built[name] = (so, regs)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier undistort.cu (32-bit count, no device "
                         "argument) to time beside the candidates")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("undistort_designs: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from slam_tricks_tpu_torch.ops import _build, undistort
    from slam_tricks_tpu_torch.residuals import camera

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    sources = variants()
    if args.parent is not None:
        sources = {"parent": args.parent.resolve(), **sources}
    built = build(sources, _build._nvcc(), _build.NVCC_FLAGS)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    intr = camera.Intrinsics(*PARAMS[:4])
    dist = camera.DistCoeffs(*PARAMS[4:])
    px = torch.as_tensor(np.random.default_rng(3).uniform(
        [50, 50], [700, 430], (NPX, 2)), dtype=torch.float32, device=dev)
    dist_px = camera.distort_pixels(intr, dist, px).contiguous()
    plain = undistort.undistort_plain(dist_px, PARAMS)
    view_buf = dist_px[:3002].clone()
    view = view_buf[1:]                     # 8 mod 16 bytes, 3,001 pixels
    view_plain = undistort.undistort_plain(view, PARAMS)

    calls = {}
    for name, (so, regs) in built.items():
        fn = ctypes.CDLL(str(so)).undistort_f32
        fn.restype = ctypes.c_int
        if name == "parent":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
                [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p]
            extra = ()
        else:
            fn.argtypes = _build.SIGNATURES["undistort_f32"]
            extra = (0,)

        def call(x, fn=fn, extra=extra):
            out = torch.empty_like(x)
            rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], *PARAMS, 5,
                    *extra, stream)
            _build.check(rc, "undistort design")
            return out

        err = float((call(dist_px) - plain).abs().max())
        err_view = float((call(view) - view_plain).abs().max())
        torch.cuda.synchronize()
        calls[name] = dict(call=lambda call=call: call(dist_px), regs=regs,
                           max_abs_err=err, view_err=err_view,
                           ms=[], device_ms=[])
    for _ in range(ROUNDS):
        for c in calls.values():
            c["ms"].append(chip_smoke._time_ms(c["call"]))
            c["device_ms"].append(chip_smoke._time_ms(c["call"],
                                                      head_start=True))
    bound_ms = chip_smoke._bound(
        2 * chip_smoke._nbytes(dist_px),
        NPX * (5 * undistort.FLOPS_PER_STEP + undistort.FLOPS_PER_PIXEL))[0]
    rows = {}
    print(smi)
    print(f"{'design':40s} regs  max|k-p| px  view px   ms       device_ms "
          f"bound share")
    for name, c in calls.items():
        ms, dms = statistics.median(c["ms"]), statistics.median(c["device_ms"])
        rows[name] = dict(regs=c["regs"], max_abs_err=c["max_abs_err"],
                          view_err=c["view_err"], ms=ms, device_ms=dms,
                          ms_rounds=c["ms"], device_ms_rounds=c["device_ms"],
                          bound_share=bound_ms / dms)
        print(f"{name:40s} {c['regs']!s:5s} {c['max_abs_err']:.3e}    "
              f"{c['view_err']:.3e}  {ms:.5f}  {dms:.5f}   "
              f"{bound_ms / dms:.3f}")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "designs.json").write_text(json.dumps(
            {"device": smi, "bound_ms": bound_ms, "designs": rows}, indent=1))


if __name__ == "__main__":
    main()
