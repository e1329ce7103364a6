"""BAL's 9-parameter cameras on the port's flat Schur path
(``residuals/bal.py``, ``ops/ba_assemble.py`` at width 9,
``solvers/schur_bal.py``) against the benchmark's plain reference
``benchmark/reference/lm_bal.py`` and finite differences, on the CPU, on
a generated photo collection of 12 cameras and 400 points with tracks of
2-12 (``benchmark/scenes/bal_city.py``), from a seeded start.

Tolerances: f64 to 1e-10 relative and tighter (the same sums in other
orders); the f32 solve within 1e-7 of the start's cost of the f64
reference after each step, and its final state's f64 cost within 1e-9 of
the start's: the f32 state's own rounding (points ~20 m across kept to
~1e-6 m) leaves a cost of ~1e-10 of the start's, and the f32 step's ~1e-8
after the first step."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, scenes
from benchmark.reference import lm_bal
from benchmark.scenes import bal_city
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.residuals import bal
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers import schur_bal
from tests.torch_util import rel_err

F64 = torch.float64
CPU = torch.device("cpu")
SPEC = dict(n_cams=12, n_points=400, n_observations=1600, seed=3,
            max_track=12)
LAM = 1e-4


def _problem(dtype=F64):
    """(scene, fixed (C,) bool, start (R, t, K, X) f64, work in dtype,
    reference problem f64)."""
    sc = bal_city.make(**SPEC)
    C, L = sc.n_cams, sc.n_points
    fixed = torch.as_tensor(scenes.fixed_mask(C, "first_last"))
    R, t, X = scenes.perturbed_start(
        torch.as_tensor(sc.R, dtype=F64), torch.as_tensor(sc.t, dtype=F64),
        torch.as_tensor(sc.points, dtype=F64), fixed,
        {"rot": 0.002, "trans": 0.02, "point": 0.02}, 5)
    gen = torch.Generator().manual_seed(6)
    K = torch.as_tensor(bal_city.intrinsics(**SPEC), dtype=F64)
    K = K + torch.randn(K.shape, generator=gen, dtype=F64) * torch.tensor(
        [1.0, 0.002, 0.0005], dtype=F64) * (~fixed)[:, None]
    obs = BAObservations(cam_idx=torch.as_tensor(sc.cam.astype(np.int32)),
                         lm_idx=torch.as_tensor(sc.lm.astype(np.int32)),
                         uv=torch.as_tensor(sc.uv, dtype=dtype),
                         weight=torch.ones(sc.cam.shape[0], dtype=dtype))
    work = schur_bal.build_bal_work(obs, C, L, dtype=dtype)
    ref = lm_bal.problem(sc.cam, sc.lm, sc.uv, sc.w, C, L, fixed.numpy(),
                         F64, CPU)
    return sc, fixed, (R, t, K, X), work, ref


@pytest.fixture(scope="module")
def case():
    return _problem()


def test_the_layout_holds_each_observation_once(case):
    """Buckets of power-of-two track lengths, every live observation in
    one slot, the pair tables holding every within-track pair (a <= b)
    once, and the counters of the layout."""
    sc, _, _, work, _ = case
    k = np.bincount(sc.lm, minlength=sc.n_points)
    assert schur_bal.LIVE_SLOTS == sc.cam.shape[0] == sum(
        int((g.w > 0).sum()) for g in work.grids)
    assert schur_bal.ALLOCATED_SLOTS == sum(g.w.numel() for g in work.grids)
    assert schur_bal.LIVE_PAIRS == int((k * (k + 1) // 2).sum())
    sizes = [g.w.shape[0] for g in work.grids]
    assert sizes == sorted(set(sizes)) and all(
        s & (s - 1) == 0 for s in sizes)
    assert schur_bal.LIVE_SLOTS / schur_bal.ALLOCATED_SLOTS > 0.7
    a = work.pairs.a.reshape(-1)
    assert int((a < work.n_slots).sum()) == schur_bal.LIVE_PAIRS
    assert torch.equal(work.perm[work.inv], torch.arange(sc.n_points))


@pytest.mark.parametrize("what", ["residual", "jacobians", "slot_rows"])
def test_the_camera_model(case, what):
    """The 9-wide residual against the reference's; its analytic
    Jacobians against central differences; the slot-major rows of
    ``ops.ba_assemble`` against the camera model's."""
    sc, _, (R, t, K, X), _, ref = case
    cam, lm = torch.as_tensor(sc.cam), torch.as_tensor(sc.lm)
    cams = bal.BALCameras(R[cam], t[cam], K[cam])
    uv = torch.as_tensor(sc.uv)
    pred, Jc, Jx = bal.jacobians(cams, X[lm])
    if what == "residual":
        mine = bal.residual(cams, X[lm], uv)
        order = np.lexsort((sc.cam, sc.lm))
        theirs = lm_bal._residuals(R, t, K, X, ref)[1]
        ref_order = np.lexsort((ref.cam.numpy(), ref.lm.numpy()))
        assert rel_err(mine[order], theirs[ref_order]) < 1e-12
        assert rel_err(pred, mine + uv) < 1e-15
    elif what == "jacobians":
        eps = 1e-6
        for i in range(9):
            d = torch.zeros(9, dtype=F64)
            d[i] = eps
            up = bal.project(bal.retract(cams, d), X[lm])
            down = bal.project(bal.retract(cams, -d), X[lm])
            assert rel_err((up - down) / (2 * eps), Jc[..., i]) < 1e-6, i
        for j in range(3):
            d = torch.zeros(3, dtype=F64)
            d[j] = eps
            fd = (bal.project(cams, X[lm] + d)
                  - bal.project(cams, X[lm] - d)) / (2 * eps)
            assert rel_err(fd, Jx[..., j]) < 1e-6, j
    else:
        from slam_tricks_tpu_torch.ops.ba_assemble import _linearize_sm
        w = torch.ones(1, cam.shape[0], dtype=F64)
        (r0, r1), (jp0, jp1), (jl0, jl1), _ = _linearize_sm(
            R.reshape(-1, 9), t, X[lm], uv[:, 0][None], uv[:, 1][None], w,
            cam[None].int(), None, K)
        assert rel_err(torch.stack([r0[0], r1[0]], -1), pred - uv) < 1e-12
        jp = torch.stack([torch.stack(jp0, -1)[0], torch.stack(jp1, -1)[0]],
                         -2)
        jl = torch.stack([torch.stack(jl0, -1)[0], torch.stack(jl1, -1)[0]],
                         -2)
        assert rel_err(jp, Jc) < 1e-12 and rel_err(jl, Jx) < 1e-12


def _blocks(case):
    sc, _, (R, t, K, X), work, _ = case
    cams = bal.BALCameras(R, t, K)
    return schur_bal._quantities(cams, X[work.perm], work)


def test_the_9_wide_assembly_matches_the_reference(case):
    """``linearize_assemble_plain`` at width 9, over the buckets, against
    the reference's normal-equation blocks (W slot by slot)."""
    sc, _, (R, t, K, X), work, ref = case
    blocks, cost = _blocks(case)
    (Hpp, gp, Hll, gl, Wo), c = lm_bal.normal_equations(R, t, K, X, ref)
    assert abs(float(cost) - float(c)) <= 1e-12 * float(c)
    assert rel_err(schur_bal._sym9_expand(blocks[0]), Hpp) < 1e-12
    assert rel_err(blocks[1], gp) < 1e-12
    inv = work.inv
    sym3 = blocks[2][[0, 1, 2, 1, 3, 4, 2, 4, 5]].T.reshape(-1, 3, 3)
    assert rel_err(sym3, Hll[work.perm]) < 1e-12
    assert rel_err(blocks[3].T, gl[work.perm]) < 1e-12
    # each reference observation's W at its slot: (bucket, k, column)
    rows = inv[ref.lm]
    for g, W in zip(work.grids, blocks[4:]):
        Lb = g.w.shape[1]
        mine = rows >= g.l0
        mine &= rows < g.l0 + Lb
        col = rows[mine] - g.l0
        cams = g.cam_of_slot[:, col].long()
        k = (cams == ref.cam[mine][None]).long().argmax(0)
        got = W[:, k, col].T.reshape(-1, 9, 3)
        assert rel_err(got, Wo[mine]) < 1e-12


def test_the_pair_formed_S_matches_the_dense_one(case):
    """S and its right-hand side from the bucketed pairs, unscaled,
    against the reference's dense per-chunk products, f64, 1e-10."""
    sc, fixed, (R, t, K, X), work, ref = case
    blocks, _ = _blocks(case)
    S, b, d = schur_bal.reduced_camera_system(
        *blocks[:4], blocks[4:], torch.tensor(LAM, dtype=F64), fixed,
        work)[:3]
    H, _ = lm_bal.normal_equations(R, t, K, X, ref)
    S_ref, b_ref = lm_bal.reduced_system(H, LAM, ref)[:2]
    assert rel_err(S / d[:, None] / d[None, :], S_ref) < 1e-10
    assert rel_err(b / d, b_ref) < 1e-10


@pytest.mark.parametrize("iters", [1, 5])
def test_the_f64_solve_follows_the_reference(case, iters):
    """One LM step's cost, and a 5-iteration solve's cost trajectory, f64,
    against the reference's from the same start; the final states the
    same."""
    sc, fixed, (R, t, K, X), work, ref = case
    costs = []
    out = schur_bal.solve_bal(se3.SE3(R, t), K, X, work, fixed_mask=fixed,
                              max_iters=iters, costs=costs)
    want = lm_bal.solve(R, t, K, X, ref, iters)
    got = [float(c) for c in costs]
    assert len(got) == len(want.costs) == iters + 1
    for g, w in zip(got, want.costs):
        assert abs(g - w) <= 1e-9 * want.costs[0], (got, want.costs)
    assert rel_err(out.points, want.X) < 1e-8
    assert rel_err(out.poses.intr, want.K) < 1e-8
    assert float(so3.log(out.poses.R.mT @ want.R).abs().max()) < 1e-8


def test_the_f32_solve_follows_the_reference(case):
    """The f32 solve from the same start (rounded to f32) against the f64
    reference: each step's cost within 1e-7 of the start's, the final
    state's f64 cost within 1e-9 of it."""
    sc, fixed, start, _, ref = case
    work = _problem(torch.float32)[3]
    R, t, K, X = (a.float() for a in start)
    costs = []
    out = schur_bal.solve_bal(se3.SE3(R, t), K, X, work, fixed_mask=fixed,
                              max_iters=5, costs=costs)
    want = lm_bal.solve(*(a.double() for a in (R, t, K, X)), ref, 5)
    c0 = want.costs[0]
    for g, w in zip(costs[1:], want.costs[1:]):
        assert abs(float(g) - w) <= 1e-7 * c0, (costs, want.costs)
    final = float(lm_bal.cost(out.poses.R.double(), out.poses.t.double(),
                              out.poses.intr.double(), out.points.double(),
                              ref))
    assert final <= 1e-9 * c0


def test_the_dubrovnik_cell_reports_its_kinds_metrics():
    """A new cell on a new traffic kind reports the end-to-end metrics of
    its kind's quantities and setup_s, with no end-to-end entry of its
    own, and every per-layer metric it reports reads with a reader made for
    that kind."""
    cell = manifest.Cell("dubrovnik-solve")
    assert {e["name"] for e in cell.e2e} == {"iter_ms", "solve_ms_p95",
                                             "setup_s"}
    assert cell.kind_name == "closed_solves_bal" and cell.per_layer
    for p in cell.per_layer:
        reader = manifest.load_reader(p["name"])
        assert "closed_solves_bal" in reader.KINDS, p["name"]
