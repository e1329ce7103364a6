"""End-to-end monocular visual odometry on the reference's real KITTI frames
(st13-directmethod/img/000000-000005.png), port of
``examples/kitti_vo_demo.py`` — the real-data validation culture of the
reference (SURVEY §4) applied to the flagship BA path:

    LK feature tracking  ->  two-view initialization (8-point + refinement)
    ->  PnP chaining      ->  full multi-frame bundle adjustment (flat Schur)
    ->  reprojection statistics + trajectory artifact

The st13 frames ship no ground-truth poses, so the quantitative gate is the
final reprojection RMS (the reference's own validation metric class, e.g.
st2-epipolar main.cpp:127-151) plus motion sanity (dominant forward motion,
small inter-frame rotation — the car drives straight in this clip).

Intrinsics: standard KITTI odometry grayscale camera (P0 of the devkit),
fx = fy = 718.856, cx = 607.1928, cy = 185.2157. The frames are read by
``read_png_gray`` (the standard library's zlib: 8-bit grayscale PNGs, as
the clip's), so nothing needs OpenCV. float32 throughout, as the JAX
example.

Run: python -m slam_tricks_tpu_torch.examples.kitti_vo_demo --frames DIR
     [--cpu] [--plot out.png]
"""

import argparse
import os
import struct
import zlib

import numpy as np
import torch

from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.frontend.optical_flow import (grid_seed_points,
                                                         lk_track)
from slam_tricks_tpu_torch.initialization.robust_epipolar import \
    robust_fundamental
from slam_tricks_tpu_torch.manifolds import lie, se3
from slam_tricks_tpu_torch.pipelines.two_view import solve_two_view
from slam_tricks_tpu_torch.residuals.reprojection import reproject_normalized
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers import schur_flat
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt

FX = FY = 718.856
CX, CY = 607.1928, 185.2157
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png_gray(path):
    """An 8-bit grayscale, non-interlaced PNG as a (H, W) uint8 array,
    decoded with zlib; raises ValueError for any other kind of PNG (colour,
    palette, alpha, 1/2/4/16-bit, interlaced) and for a file that is not a
    PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour != 0 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNGs "
                         f"are read (bit depth {depth}, colour type {colour},"
                         f" interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{height} rows of {width} pixels")
    rows = raw.reshape(height, width + 1)
    img = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.int64)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if ftype == 0:                                  # None
            cur = line
        elif ftype == 1:                                # Sub
            cur = np.cumsum(line) & 0xFF
        elif ftype == 2:                                # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                           # Average, Paeth
            cur = np.zeros(width, np.int64)
            left = 0
            for x in range(width):
                if ftype == 3:
                    pred = (left + int(prev[x])) >> 1
                else:
                    pred = _paeth(left, int(prev[x]),
                                  int(prev[x - 1]) if x else 0)
                left = (int(line[x]) + pred) & 0xFF
                cur[x] = left
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        img[y] = cur
        prev = cur
    return img


def load_frames(frame_dir):
    frames = []
    for name in sorted(os.listdir(frame_dir)):
        if name.endswith(".png"):
            img = read_png_gray(os.path.join(frame_dir, name))
            frames.append(img.astype(np.float32) / 255.0)
    return frames


def track_sequence(frames, device):
    """LK-chain grid-seeded features through the whole clip. Returns
    (uv_px (F, M, 2), alive (F, M) bool) — a feature stays in the table while
    tracking succeeds in every frame (full-length tracks only)."""
    h, w = frames[0].shape
    pts0 = grid_seed_points(h, w, grid=12, pts_per_cell=2, margin=20, seed=0)
    uv = [pts0]
    alive = [np.ones(pts0.shape[0], bool)]
    cur = torch.as_tensor(pts0, device=device)
    for k in range(1, len(frames)):
        nxt, ok = lk_track(torch.as_tensor(frames[k - 1], device=device),
                           torch.as_tensor(frames[k], device=device),
                           cur, levels=3, win=9, iters=12)
        nxt_np = nxt.cpu().numpy()
        okn = ok.cpu().numpy() & np.isfinite(nxt_np).all(axis=1)
        inb = ((nxt_np[:, 0] > 5) & (nxt_np[:, 0] < w - 5)
               & (nxt_np[:, 1] > 5) & (nxt_np[:, 1] < h - 5))
        alive.append(alive[-1] & okn & inb)
        uv.append(nxt_np)
        cur = nxt
    return np.stack(uv), np.stack(alive)


def _project_all(poses, points, obs):
    cam = obs.cam_idx.cpu().numpy()
    R = poses.R.cpu().numpy()[cam]
    t = poses.t.cpu().numpy()[cam]
    p = points.cpu().numpy()[obs.lm_idx.cpu().numpy()]
    pc = np.einsum("nij,nj->ni", R, p) + t
    return pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)


def normalized(uv_px):
    return np.stack([(uv_px[..., 0] - CX) / FX, (uv_px[..., 1] - CY) / FY],
                    axis=-1)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--frames", required=True,
                    help="the directory of the clip's frames (the "
                         "reference repo's st13-directmethod/img)")
    ap.add_argument("--plot", default=None)
    return ap


def run(args):
    """The pipeline on the frames of args.frames; returns the final BA
    state and the numbers it prints (reprojection RMS in px, the
    forward-motion fraction, the largest rotation in degrees, BA
    iterations, the track counts)."""
    dev = example_device(args.cpu)
    frames = load_frames(args.frames)
    F = len(frames)
    print(f"[kitti-vo] {F} frames {frames[0].shape}")

    uv_px, alive = track_sequence(frames, dev)
    full = alive[-1]                       # tracks alive through all frames
    # minimum parallax gate: static points break monocular init
    par = np.linalg.norm(uv_px[-1] - uv_px[0], axis=1)
    keep = full & (par > 2.0)
    uv_px = uv_px[:, keep]
    M = uv_px.shape[1]
    print(f"[kitti-vo] {M} full-length tracks (of {full.shape[0]} seeds)")
    uvn = normalized(uv_px).astype(np.float32)

    def T_(a):
        return torch.as_tensor(a, device=dev)

    # ---- outlier gate: robust essential-matrix RANSAC + chi2 loop on the
    # widest baseline (the st2 epipolar machinery, epipolar.hpp:139-209) ----
    _, inl, _ = robust_fundamental(T_(uvn[0]), T_(uvn[-1]),
                                   sigma2=(1.5 / FX) ** 2, essential=True)
    inl = inl.cpu().numpy()
    print(f"[kitti-vo] epipolar inliers {int(inl.sum())}/{M}")
    uv_px = uv_px[:, inl]
    uvn = uvn[:, inl]
    M = uv_px.shape[1]

    # ---- two-view init on the widest baseline (frame 0 -> last) ----
    tv = solve_two_view(T_(uvn[0]), T_(uvn[-1]), refine_iters=30)
    print(f"[kitti-vo] two-view: cheirality {int(tv.n_cheiral)}/{M}, "
          f"cost {float(tv.final_cost):.3e}")
    X0 = tv.points.cpu().numpy()           # landmarks in frame-0 camera frame

    # ---- chain intermediate poses by motion-only LM (PnP) on X0 ----
    dtype = np.float32
    poses_R = [np.eye(3, dtype=dtype)]
    poses_t = [np.zeros(3, dtype=dtype)]
    good = (X0[:, 2] > 0.5) & np.isfinite(X0).all(axis=1)
    X0_t = T_(X0.astype(dtype))
    w = T_(good.astype(dtype))
    for k in range(1, F):
        frac = k / (F - 1)
        xi = frac * se3.log(tv.T_12).cpu().numpy()
        T0_k = se3.exp(T_(xi.astype(dtype)))

        def resid(T, uv_k=T_(uvn[k])):
            return reproject_normalized(T, X0_t, uv_k) * w[:, None]

        res = levenberg_marquardt(resid, T0_k, lie(se3), max_iters=15)
        poses_R.append(res.x.R.cpu().numpy())
        poses_t.append(res.x.t.cpu().numpy())
    print("[kitti-vo] PnP chaining done")

    # ---- full-sequence BA (flat Schur path) ----
    cam_idx = np.repeat(np.arange(F), M).astype(np.int32)
    lm_idx = np.tile(np.arange(M), F).astype(np.int32)
    uv_all = uvn.reshape(F * M, 2)
    w_all = np.tile(good.astype(dtype), F)
    pad = (-len(cam_idx)) % 8
    obs = BAObservations(
        cam_idx=T_(np.concatenate([cam_idx, np.zeros(pad, np.int32)])),
        lm_idx=T_(np.concatenate([lm_idx, np.zeros(pad, np.int32)])),
        uv=T_(np.concatenate([uv_all, np.zeros((pad, 2), dtype)])),
        weight=T_(np.concatenate([w_all, np.zeros(pad, dtype)])))
    poses0 = se3.SE3(T_(np.stack(poses_R)), T_(np.stack(poses_t)))
    points0 = T_(X0.astype(dtype))
    fixed = torch.zeros(F, dtype=torch.bool, device=dev)
    fixed[0] = True

    work = schur_flat.build_flat_work(obs, F, M, dtype=torch.float32)
    out = schur_flat.solve_ba_flat(poses0, points0, obs, work,
                                   fixed_mask=fixed, max_iters=40)

    # trim pass: drop tracks whose residual stays far beyond the bulk
    # (LK drift / moving objects), then re-solve — the two-pass trimming the
    # reference's chi2 loop applies per-iteration (st2 epipolar.hpp:139-209)
    for round_ in range(2):
        r = obs.uv.cpu().numpy() - _project_all(out.poses, out.points, obs)
        weight = obs.weight.cpu().numpy()
        lm_np = obs.lm_idx.cpu().numpy()
        valid = weight > 0
        pe = np.sqrt((r ** 2).sum(axis=1)) * valid
        per_track = np.zeros(M)
        cnt = np.zeros(M)
        np.add.at(per_track, lm_np, pe)
        np.add.at(cnt, lm_np, valid.astype(float))
        per_track /= np.maximum(cnt, 1)
        med = np.median(per_track[cnt > 0])
        bad_track = (per_track > (4 - round_) * med) & (cnt > 0)
        if not bad_track.any():
            break
        w_new = weight * (~bad_track)[lm_np]
        obs = obs._replace(weight=T_(w_new.astype(dtype)))
        print(f"[kitti-vo] round {round_}: trimmed {int(bad_track.sum())} "
              f"outlier tracks (median {med * FX:.2f} px)")
        work = schur_flat.build_flat_work(obs, F, M, dtype=torch.float32)
        out = schur_flat.solve_ba_flat(out.poses, out.points, obs, work,
                                       fixed_mask=fixed, max_iters=30)
    n_eff = float(obs.weight.sum())
    rms_n = np.sqrt(float(out.cost) / n_eff)
    rms_px = rms_n * FX
    print(f"[kitti-vo] BA: {int(out.it)} iters, reprojection RMS "
          f"{rms_px:.3f} px ({rms_n:.2e} normalized)")

    # motion sanity: camera centers c = -R^T t, forward = +z in camera frame
    R_f = out.poses.R.cpu().numpy()
    t_f = out.poses.t.cpu().numpy()
    centers = -np.einsum("fji,fj->fi", R_f, t_f)
    step = np.diff(centers, axis=0)
    fwd_frac = (np.abs(step[:, 2]).sum()
                / (np.linalg.norm(step, axis=1).sum() + 1e-12))
    rot_deg = [np.degrees(np.arccos(np.clip((np.trace(R_f[k]) - 1) / 2, -1,
                                            1)))
               for k in range(F)]
    print(f"[kitti-vo] forward-motion fraction {fwd_frac:.2f}, "
          f"max |rot| {max(rot_deg):.2f} deg")
    return {"state": out, "rms_px": float(rms_px),
            "fwd_frac": float(fwd_frac), "max_rot_deg": float(max(rot_deg)),
            "iters": int(out.it), "tracks": int(M)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args)
    if args.plot:
        from slam_tricks_tpu_torch.viz.plots import plot_ba_scene
        plot_ba_scene(args.plot, out["state"].poses, out["state"].points,
                      title="KITTI st13 clip: VO + BA")
        print(f"[kitti-vo] wrote {args.plot}")
    return out


if __name__ == "__main__":
    main()
