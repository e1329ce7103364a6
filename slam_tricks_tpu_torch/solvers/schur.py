"""Block-sparse Schur-complement bundle adjustment over an observation list
(port of ``slam_tricks_tpu/solvers/schur.py``), and the LM state, track
table, control law and loop that every Schur solver of the port shares.

``solve_ba`` is the package's reference solver: per-observation residuals
and analytic Jacobians (``residuals.reprojection``), the normal-equation
blocks summed per camera and per landmark, the landmarks eliminated by
batched 3x3 algebra, and the reduced camera system S solved by one of four
``linear_solver``s: ``"dense"`` (S from the whitened block matrix B, one
matrix product), ``"paired"`` (S from within-track observation pairs,
O(N) memory: the exact comparator at large C), ``"tracks"`` and ``"pcg"``
(matrix-free, ``solvers/pcg.py``). The JAX package's ``"tracks"`` builds
the dense solve's B through the track table, since scatters serialize on
a TPU; here the dense solve's fixed-order table sums already avoid
scatters, so ``"tracks"`` takes the track table for the JAX signature and
runs the dense solve. The exact ones factor S with ``ops.spd_solve``, the
CUDA kernel on the card. Every sum over observations runs in an order fixed before the LM
loop (``common.sum_table`` / ``table_sum``), so the card returns the same
bits on every run, where ``index_add_`` sums by float atomics; the JAX
package's ``segment_sum`` and one-hot products compute the same sums.

Gauge: fixed cameras get identity rows and columns in S. Tangent per
camera: [omega, dt] (SO(3) x R^3), poses stored as T_cw. The LM loops
(``lm_loop``, ``lm_graphed``) also carry BAL's cameras
(``residuals.bal.BALCameras``: the pose and its focal length and two
distortion terms, tangent [omega, dt, df, dk1, dk2], the intrinsics
retracted additively) wherever a solver passes them in the pose's place.
"""

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.ops.smallchol import (cholesky_small,
                                                 solve_lower_small)
from slam_tricks_tpu_torch.ops.spd_solve import spd_solve
from slam_tricks_tpu_torch.residuals import bal, robust
from slam_tricks_tpu_torch.residuals.reprojection import \
    reproject_normalized_jacobians
from slam_tricks_tpu_torch.solvers.common import (first_camera_fixed, psum,
                                                  set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.utils.timer import annotate


class BAState(NamedTuple):
    poses: se3.SE3          # stacked (C,)
    points: torch.Tensor    # (L, 3)
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: int                 # LM iterations run
    done: bool              # stopped on the step-size test


class TrackTable(NamedTuple):
    """obs_idx[l, k] is the k-th observation of landmark l in the flat
    observation arrays; mask marks the real entries. numpy, host side."""
    obs_idx: np.ndarray     # (L, K) int32
    mask: np.ndarray        # (L, K) 1/0


def build_track_table(cam_idx, lm_idx, weight=None, *, n_points=None,
                      dtype=np.float32):
    """Group observation indices by landmark (stable, in input order) and pad
    to the longest track rounded up to a multiple of 8. Padding entries
    point at observation 0 with mask 0."""
    lm_idx = np.asarray(lm_idx)
    keep = (np.ones(lm_idx.shape[0], bool) if weight is None
            else np.asarray(weight) > 0)
    L = int(n_points) if n_points is not None else int(lm_idx.max()) + 1
    valid = np.flatnonzero(keep)
    order = valid[np.argsort(lm_idx[valid], kind="stable")]
    lm_sorted = lm_idx[order]
    counts = np.bincount(lm_sorted, minlength=L)
    K = int(counts.max()) if counts.size else 1
    K = K + (-K) % 8
    obs_idx = np.zeros((L, K), np.int32)
    mask = np.zeros((L, K), dtype)
    starts = np.zeros(L + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # each sorted observation lands at (its landmark, its rank in the track)
    slot = np.arange(lm_sorted.shape[0]) - starts[lm_sorted]
    obs_idx[lm_sorted, slot] = order
    mask[lm_sorted, slot] = 1
    return TrackTable(obs_idx=obs_idx, mask=mask)


def lm_accept(cost_old, cost_try, lam, nu, pred, bad, lam_min=1e-12):
    """Nielsen gain-ratio trust-region update, the control law every LM loop
    of the JAX package shares. pred is the predicted model decrease; the
    new damping is clipped to [lam_min, 1e10] (the pose-graph solvers
    clip at 1e-14).

    Returns (accept, lam_new, nu_new), all tensors on the device."""
    rho = (cost_old - cost_try) / torch.clamp_min(pred, 1e-30)
    accept = (cost_try < cost_old) & torch.isfinite(cost_try) & (~bad)
    lam_new = torch.where(
        accept,
        lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0),
        lam * nu)
    lam_new = torch.clamp(lam_new, lam_min, 1e10)
    nu_new = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return accept, lam_new, nu_new


def _retract_state(poses, points, dp, dl):
    """The step on SO(3) x R^3: R exp(omega), t + dt, points + dl; BAL's
    cameras (``residuals.bal.BALCameras``) also f + df, k1 + dk1,
    k2 + dk2."""
    if isinstance(poses, bal.BALCameras):
        return bal.retract(poses, dp), points + dl
    return (se3.SE3(so3.retract(poses.R, dp[:, :3]), poses.t + dp[:, 3:]),
            points + dl)


def lm_retract(poses, points, dp, dl, psum_axis=None):
    """The finiteness guard and the trial state of one LM step: a step that
    is not finite (on any rank of psum_axis) becomes a zero step. Returns
    (bad, dp_s, dl_s, poses_try, points_try)."""
    bad = ~(torch.isfinite(dp).all() & torch.isfinite(dl).all())
    if psum_axis is not None:
        # every rank must agree before the replicated state is touched
        bad = psum((bad.to(dp.dtype),), psum_axis)[0] > 0
    dp_s = torch.where(bad, torch.zeros_like(dp), dp)
    dl_s = torch.where(bad, torch.zeros_like(dl), dl)
    poses_try, points_try = _retract_state(poses, points, dp_s, dl_s)
    return bad, dp_s, dl_s, poses_try, points_try


def lm_decide(cost, cost_try, lam, nu, dp_s, dl_s, diag_pp, diag_ll, gp, gl,
              bad, *, xtol, gtol=0.0, psum_axis=None, n_local=None):
    """The model decrease, the control law and the stop test of one LM
    step (``lm_loop``'s arguments). Returns (accept, lam, nu, stop), device
    tensors."""
    if psum_axis is None:
        pred_l = torch.sum(dl_s * (lam * diag_ll * dl_s - gl))
        step_l = torch.sum(dl_s * dl_s)
    else:
        pred_l, step_l = _landmark_terms(
            dl_s, lam * diag_ll * dl_s - gl, psum_axis, n_local)
    pred = 0.5 * (torch.sum(dp_s * (lam * diag_pp * dp_s - gp)) + pred_l)
    accept, lam, nu = lm_accept(cost, cost_try, lam, nu, pred, bad)
    step_sq = torch.sum(dp_s * dp_s) + step_l
    stop = accept & (step_sq < xtol * xtol)
    if gtol > 0:
        stop = stop | (torch.maximum(gp.abs().max(), gl.abs().max()) < gtol)
    return accept, lam, nu, stop


def lm_select(accept, new, old, inplace=False):
    """torch.where(accept, n, o) of each pair of the sequences new and old;
    inplace=True writes each into its o instead of a new tensor. Returns a
    tuple."""
    return tuple(torch.where(accept, n, o, out=o) if inplace
                 else torch.where(accept, n, o) for n, o in zip(new, old))


EAGER_ITERATIONS = 0    # LM iterations run without a CUDA graph since import
GRAPH_CAPTURES = 0      # CUDA graphs captured by ``lm_graphed``
GRAPH_REPLAYS = 0       # and their replays


def lm_loop(poses0, points0, quantities, solve, *, max_iters,
            lambda_init=1e-4, xtol=1e-12, gtol=0.0, costs=None,
            callback=None, grads=None, psum_axis=None, n_local=None):
    """The Levenberg-Marquardt loop of the JAX package's Schur solvers, run
    on the host over device tensors with one sync (the stop flag) a step.

    quantities(poses, points) -> (blocks, cost), blocks a tuple of tensors
    in the solver's layout that starts (Hpp, gp, Hll, gl (3, L), ...);
    solve(blocks, lam) -> (dp (C, 6), dl (L, 3), diag_pp (C, 6),
    diag_ll (L, 3)). Steps retract on SO(3) x R^3 (tangent [omega, dt]);
    poses may be BAL's cameras, with 9-wide dp and diag_pp
    (``_retract_state``);
    the predicted reduction uses the Marquardt diagonals and the gradients
    grads(blocks) -> (gp (C, 6), gl (L, 3)), by default (blocks[1],
    blocks[3].T). lambda_init is the first damping; the loop stops when an
    accepted step is shorter than xtol, or, with gtol > 0, after a step
    taken where the gradients' largest magnitude was below gtol. If `costs`
    is a list, the cost at the start and after each step is appended to it
    (device scalars); callback(it, cost, lam) is called after each step
    with the 0-based step count and the state it leaves. Returns a
    BAState.

    psum_axis: a ``torch.distributed`` process group whose ranks each run
    this loop on their own landmarks (the distributed solvers of
    ``parallel/``), or None (one process, no collective). quantities must
    then return the camera blocks and the cost summed over the ranks, and
    solve a dp that every rank computes alike; the loop sums the first
    n_local landmark rows' step and model-decrease terms over the ranks
    (all rows when None; the rows after them are replicated on every rank,
    as the loop-closure landmarks of ``parallel/loop_dist``) and a step
    that is not finite on any rank, so that every rank takes the same
    decisions from the same numbers and leaves the loop at the same step.
    gtol > 0 is refused with a group.

    Spans (``utils.timer.annotate``, recorded only while a profiler runs):
    ``slam:lm.linearize`` around each quantities call, ``slam:lm.iter``
    around an iteration, holding ``slam:lm.solve``, ``slam:lm.retract``
    (the finiteness guard and the retract), the trial's
    ``slam:lm.linearize``, ``slam:lm.accept`` (the model decrease, the
    control law, the stop test and the state's selection) and
    ``slam:sync.stop``, the host's wait for the stop flag."""
    global EAGER_ITERATIONS
    if psum_axis is not None and gtol > 0:
        raise ValueError("lm_loop: gtol > 0 is not supported with psum_axis")
    dtype, device = points0.dtype, points0.device
    poses, points = poses0, points0
    with annotate("slam:lm.linearize"):
        blocks, cost = quantities(poses, points)
    lam = torch.tensor(lambda_init, dtype=dtype, device=device)
    nu = torch.tensor(2.0, dtype=dtype, device=device)
    it, done = 0, False
    if costs is not None:
        costs.append(cost)
    while not done and it < max_iters:
        with annotate("slam:lm.iter"):
            gp, gl = ((blocks[1], blocks[3].T) if grads is None
                      else grads(blocks))
            with annotate("slam:lm.solve"):
                dp, dl, diag_pp, diag_ll = solve(blocks, lam)
            with annotate("slam:lm.retract"):
                bad, dp_s, dl_s, poses_try, points_try = lm_retract(
                    poses, points, dp, dl, psum_axis)
            with annotate("slam:lm.linearize"):
                blocks_try, cost_try = quantities(poses_try, points_try)

            with annotate("slam:lm.accept"):
                accept, lam, nu, stop = lm_decide(
                    cost, cost_try, lam, nu, dp_s, dl_s, diag_pp, diag_ll,
                    gp, gl, bad, xtol=xtol, gtol=gtol, psum_axis=psum_axis,
                    n_local=n_local)
                *cams, points, cost = lm_select(
                    accept, (*poses_try, points_try, cost_try),
                    (*poses, points, cost))
                poses = type(poses)(*cams)
                blocks = lm_select(accept, blocks_try, blocks)
            if callback is not None:
                callback(it, cost, lam)
            it += 1
            EAGER_ITERATIONS += 1
            if costs is not None:
                costs.append(cost)
            with annotate("slam:sync.stop"):
                done = bool(stop)                       # one sync a step
    return BAState(poses=poses, points=points, cost=cost, lam=lam, nu=nu,
                   it=it, done=done)


# ---- the loop as CUDA graphs ----

class SchurSteps(NamedTuple):
    """A Schur solver's LM step in the pieces that ``lm_graphed`` runs
    apart: the calls that launch the hand-written kernels (linearize,
    linear_solve) run eagerly; system and back_substitute, plain torch,
    are captured. Each calls its function through the solver module's own
    name, so that whoever wraps that name sees the call."""
    linearize: Callable         # (poses, points, out) -> (blocks, cost),
    #                             written into out
    linearize_out: Callable     # () -> a new `out` for linearize
    system: Callable            # (blocks, lam, replay=None) -> the reduced
    #                             system, a tuple of tensors
    linear_solve: Callable      # (system, out) -> dp (C, 6), a view of out
    solve_out: Callable         # () -> a new `out` for linear_solve
    back_substitute: Callable   # (dp, blocks, system) -> dl (L, 3)
    diagonals: Callable         # system -> (diag_pp (C, 6), diag_ll (L, 3))
    keep: tuple = ()            # tensors the segments read from a bounded
    #                             cache: the graphs read them by address
    system_stages: tuple = ()   # the reduced system in stages, each
    #                             stage(blocks, lam, done) -> a tuple of
    #                             tensors (done: the earlier stages'
    #                             results), captured as a graph each;
    #                             system then gets the tuple of their graphs
    #                             as `replay`. Empty: system is one graph


class _Key(NamedTuple):
    held: tuple       # objects a capture read by address: compared by identity
    values: tuple     # numbers and settings it baked in: compared by value

    def matches(self, other):
        return (len(self.held) == len(other.held)
                and all(a is b for a, b in zip(self.held, other.held))
                and self.values == other.values)


def _captured(fn, pool, stream):
    """(graph, fn's result): fn captured on `stream` into the memory pool
    `pool`, as torch.cuda.graph captures less its empty_cache and
    gc.collect, which would empty the whole process's allocator cache at
    every capture (its synchronize: once a layout, in _capture)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool)
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out


_SIDES = {}     # device index -> (side stream, a graph that keeps the pool)


def _side(device):
    """(stream, pool): the side stream and the memory pool of every
    layout's warm-up and graphs on `device`. The caching allocator reuses a
    freed block only on the stream that made it, and frees a graph pool
    only at an empty_cache once its last graph is gone, so a stream and a
    pool of each layout's own would keep every evicted layout's memory
    reserved; one of each, the pool held by a graph of one fill that is
    never replayed, hands an evicted layout's blocks to the next."""
    if device.index not in _SIDES:
        stream = torch.cuda.Stream(device)
        _SIDES[device.index] = stream, _captured(
            lambda: torch.zeros(1, device=device),
            torch.cuda.graph_pool_handle(), stream)[0]
    stream, keeper = _SIDES[device.index]
    return stream, keeper.pool()


class _Graph:
    """One captured segment: its CUDA graph and the outputs it writes."""

    def __init__(self, fn, pool, stream):
        global GRAPH_CAPTURES
        self.graph, self.out = _captured(fn, pool, stream)
        GRAPH_CAPTURES += 1

    def __call__(self):
        global GRAPH_REPLAYS
        self.graph.replay()
        GRAPH_REPLAYS += 1
        return self.out


class _LoopGraphs:
    """One layout's graphed LM iteration: the static tensors that hold the
    state, the trial and the kernels' results, and, once captured, the four
    segments' graphs (reduced system, back-substitution, retract, accept;
    the reduced system's a tuple of graphs where the steps give it in
    stages)."""

    def __init__(self, key, steps, poses0, points0, xtol):
        self.key, self.steps, self.xtol = key, steps, xtol
        # each of the caller's dtype and device: a mismatch raises in the
        # kernel's wrapper, as in lm_loop, and is not converted here; the
        # cameras' tensors (R, t, and BAL's intrinsics) in their type's order
        self.kind = type(poses0)
        self.cams = tuple(x.new_empty(x.shape) for x in poses0)
        self.X = points0.new_empty(points0.shape)
        self.lam = points0.new_empty(())
        self.nu = points0.new_empty(())
        self.state_out = steps.linearize_out()
        self.trial_out = steps.linearize_out()
        self.dp_out = steps.solve_out()
        self.side, self.pool = _side(points0.device)
        self.graphs = None

    # the segments: each reads what the ones before it left in self
    def _system(self):
        return self.steps.system(self.blocks, self.lam)

    def _back_substitute(self):
        return self.steps.back_substitute(self.dp, self.blocks, self.system)

    def _poses(self):
        return self.kind(*self.cams)

    def _retract(self):
        return lm_retract(self._poses(), self.X, self.dp, self.dl)

    def _accept(self):
        bad, dp_s, dl_s, poses_try, points_try = self.trial
        diag_pp, diag_ll = self.steps.diagonals(self.system)
        accept, lam, nu, stop = lm_decide(
            self.cost, self.cost_try, self.lam, self.nu, dp_s, dl_s, diag_pp,
            diag_ll, self.blocks[1], self.blocks[3].T, bad, xtol=self.xtol)
        lm_select(accept, (*poses_try, points_try,
                           self.cost_try) + tuple(self.blocks_try),
                  (*self.cams, self.X, self.cost) + tuple(self.blocks),
                  inplace=True)
        self.lam.copy_(lam)
        self.nu.copy_(nu)
        return stop

    def _iteration(self):
        """One LM iteration, in ``lm_loop``'s spans: each segment replayed,
        or run eagerly before the capture. Returns the stop flag."""
        st, g = self.steps, self.graphs
        run = (lambda i, fn: fn()) if g is None else (lambda i, fn: g[i]())
        with annotate("slam:lm.solve"):
            with annotate("slam:rcs"):
                self.system = st.system(self.blocks, self.lam,
                                        replay=None if g is None else g[0])
            with annotate("slam:linear_solve"):
                self.dp = st.linear_solve(self.system, self.dp_out)
            with annotate("slam:backsub"):
                self.dl = run(1, self._back_substitute)
        with annotate("slam:lm.retract"):
            self.trial = run(2, self._retract)
        with annotate("slam:lm.linearize"):
            self.blocks_try, self.cost_try = st.linearize(
                self.trial[3], self.trial[4], self.trial_out)
        with annotate("slam:lm.accept"):
            return run(3, self._accept)

    def _warm_up(self):
        """The first iteration of a layout, eagerly on a side stream, as
        ``torch.cuda.graph`` asks before a capture."""
        global EAGER_ITERATIONS
        main = torch.cuda.current_stream(self.X.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            stop = self._iteration()
        main.wait_stream(self.side)
        EAGER_ITERATIONS += 1
        return stop

    def _capture_stages(self):
        """The reduced system's stages, a graph each, each reading the
        outputs of the ones before: (their graphs, the last one's
        output)."""
        graphs, done = [], ()
        for stage in self.steps.system_stages:
            graphs.append(_Graph(functools.partial(stage, self.blocks,
                                                   self.lam, done),
                                 self.pool, self.side))
            done += (graphs[-1].out,)
        return tuple(graphs), done[-1]

    def _capture(self):
        """The four segments, in order, into graphs on the device's pool:
        each captured output stands where the next segment reads it."""
        with annotate("slam:graph.capture"):
            torch.cuda.synchronize(self.X.device)
            graphs = []
            if self.steps.system_stages:
                staged, self.system = self._capture_stages()
                graphs.append(staged)
            for fn, name in ((self._system, "system"),
                             (self._back_substitute, "dl"),
                             (self._retract, "trial"),
                             (self._accept, "stop"))[len(graphs):]:
                graphs.append(_Graph(fn, self.pool, self.side))
                setattr(self, name, graphs[-1].out)
            self.graphs = graphs

    def solve(self, poses0, points0, max_iters, lambda_init, costs):
        for c, x in zip(self.cams, poses0):
            c.copy_(x)
        self.X.copy_(points0)
        self.lam.fill_(lambda_init)
        self.nu.fill_(2.0)
        with annotate("slam:lm.linearize"):
            self.blocks, self.cost = self.steps.linearize(
                self._poses(), self.X, self.state_out)
        if costs is not None:
            costs.append(self.cost.clone())
        it, done = 0, False
        while not done and it < max_iters:
            with annotate("slam:lm.iter"):
                stop = (self._warm_up() if self.graphs is None
                        else self._iteration())
                it += 1
                if costs is not None:
                    costs.append(self.cost.clone())
                with annotate("slam:sync.stop"):
                    done = bool(stop)                   # one sync a step
            if self.graphs is None and not done and it < max_iters:
                self._capture()     # only where a replay follows
        # values of their own: the next solve overwrites the static tensors
        return BAState(poses=self.kind(*(c.clone() for c in self.cams)),
                       points=self.X.clone(), cost=self.cost.clone(),
                       lam=self.lam.clone(), nu=self.nu.clone(), it=it,
                       done=done)


_GRAPHS = [None]    # the last layout's _LoopGraphs: the cache holds one


def release_graphs():
    """Drop ``lm_graphed``'s cache: the last graphed layout's CUDA graphs,
    the static tensors and the references to the layout and fixed mask
    they read, and the graphs' memory pool, which the next
    ``torch.cuda.empty_cache()`` returns to the device. The next graphed
    solve captures anew."""
    _GRAPHS[0] = None
    _SIDES.clear()


def lm_graphed(poses0, points0, held, values, make_steps, *, max_iters,
               lambda_init=1e-4, xtol=1e-12, costs=None):
    """``lm_loop`` on CUDA tensors with one process and no callback, as CUDA
    graphs: the reduced camera system, the back-substitution, the retract
    and the accept are each one graph, replayed in ``lm_loop``'s spans, and
    the hand-written kernels (linearize + assemble, the linear solve) are
    launched between them into static tensors. The same step functions as
    ``lm_loop``'s, so the same bits; one sync a step, the stop flag.

    held: the objects the graphs read by address (the layout, the fixed
    mask or None), values: what they bake in (the solver, the loss, xtol);
    make_steps() -> the solver's ``SchurSteps``, called when the cache (one
    layout, the last, on any device) holds no graphs of this key. A
    layout's first solve runs its first iteration eagerly and, where a
    second follows, captures the graphs after it (span
    ``slam:graph.capture``); a solve that stops after one iteration
    captures nothing. The cache keeps the layout, the fixed mask and the
    graphs' memory alive until another key's solve or ``release_graphs()``.
    Returns a BAState whose tensors, and `costs`' entries, are copies of
    their own."""
    key = _Key(tuple(held), tuple(values) + tuple(
        (x.dtype, x.device, tuple(x.shape)) for x in (*poses0, points0)))
    entry = _GRAPHS[0]
    if entry is None or not entry.key.matches(key):
        _GRAPHS[0] = entry = None       # the last layout's graphs go first
        entry = _GRAPHS[0] = _LoopGraphs(key, make_steps(), poses0, points0,
                                         xtol)
    return entry.solve(poses0, points0, max_iters, lambda_init, costs)


def _landmark_terms(dl, a, group, n_local):
    """(sum of dl a, sum of dl²) over the landmark rows: the first n_local
    rows (all when None) summed over the ranks of `group`, the rest, which
    every rank holds alike, added after the sum."""
    n = dl.shape[0] if n_local is None else n_local
    pred_l, step_l = psum(((dl[:n] * a[:n]).sum(),
                           (dl[:n] * dl[:n]).sum()), group)
    return (pred_l + (dl[n:] * a[n:]).sum(),
            step_l + (dl[n:] * dl[n:]).sum())


# ---- the observation-list solver (solve_ba) ----

PAIR_SEGMENT = 64   # pairs summed per segment of the paired assembly


class ObsTables(NamedTuple):
    """The fixed summation orders of one observation list (``sum_table``
    tables over the live observations, weight > 0), built once a problem."""
    cam: torch.Tensor               # (C, T) the observations of each camera
    lm: torch.Tensor                # (L, T) of each landmark
    block: Optional[torch.Tensor]   # (L C, T) of each (landmark, camera)
    #                                 block of B, the dense solve only


def obs_tables(cam_idx, lm_idx, n_cams, n_points, weight=None, blocks=False):
    """The ``ObsTables`` of an observation list; weight None counts every
    observation live; blocks=True adds the (landmark, camera) table."""
    cam, lm = cam_idx.long(), lm_idx.long()
    if weight is not None:
        live = weight > 0
        cam = torch.where(live, cam, -1)
        lm = torch.where(live, lm, -1)
    block = None
    if blocks:
        block = sum_table(torch.where(cam >= 0, lm * n_cams + cam, -1),
                          n_points * n_cams)
    return ObsTables(sum_table(cam, n_cams), sum_table(lm, n_points), block)


def _residuals(poses, points, cam_idx, lm_idx, uv):
    cam, lm = cam_idx.long(), lm_idx.long()
    pc = (poses.R[cam] @ points[lm][:, :, None])[:, :, 0] + poses.t[cam]
    return pc[:, :2] / pc[:, 2:] - uv


def _linearize_obs(poses, points, cam_idx, lm_idx, uv, weight):
    """Per-observation residual and Jacobians, sqrt-weighted: (r (N, 2),
    Jp (N, 2, 6), Jl (N, 2, 3)). An observation of weight 0 gives zeros
    (also where its camera sees the point at z = 0)."""
    cam, lm = cam_idx.long(), lm_idx.long()
    T = se3.SE3(poses.R[cam], poses.t[cam])
    pred, Jp, Jl = reproject_normalized_jacobians(T, points[lm])
    sw = torch.sqrt(weight)[:, None]
    live = (weight > 0)[:, None]
    r = torch.where(live, (pred - uv) * sw, 0.0)
    Jp = torch.where(live[..., None], Jp * sw[..., None], 0.0)
    Jl = torch.where(live[..., None], Jl * sw[..., None], 0.0)
    return r, Jp, Jl


def _cost(poses, points, cam_idx, lm_idx, uv, weight):
    r = _residuals(poses, points, cam_idx, lm_idx, uv)
    return 0.5 * torch.sum(weight[:, None] * r * r)


def _assemble(r, Jp, Jl, cam_idx, lm_idx, n_cams, n_points, tables=None):
    """Normal-equation blocks, summed per camera and per landmark in the
    fixed orders of `tables` (``obs_tables``; built here when None):
    (Hpp (C, 6, 6), Hll (L, 3, 3), gp (C, 6), gl (L, 3), W_obs (N, 6, 3))."""
    if tables is None:
        tables = obs_tables(cam_idx, lm_idx, n_cams, n_points)
    N = r.shape[0]
    Hpp = table_sum(torch.einsum("nri,nrj->nij", Jp, Jp).reshape(N, 36).T,
                    tables.cam).reshape(n_cams, 6, 6)
    Hll = table_sum(torch.einsum("nri,nrj->nij", Jl, Jl).reshape(N, 9).T,
                    tables.lm).reshape(n_points, 3, 3)
    gp = table_sum(torch.einsum("nri,nr->in", Jp, r), tables.cam)
    gl = table_sum(torch.einsum("nri,nr->in", Jl, r), tables.lm)
    W_obs = torch.einsum("nri,nrj->nij", Jp, Jl)
    return Hpp, Hll, gp, gl, W_obs


def _inv3x3(A):
    """Closed-form inverse of (..., 3, 3) SPD blocks by the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    rows = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                        torch.stack([A21, A22, A23], dim=-1),
                        torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return rows * (1.0 / det)[..., None, None]


def _damp_blocks(H, lam):
    """H + lam diag(max(diag H, 1e-12)) of batched diagonal blocks."""
    d = torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1), 1e-12)
    return H + lam * torch.diag_embed(d)


def _damp_hll(Hll, lam):
    """Damped landmark blocks, an empty one (zero trace: no live
    observation) replaced by the identity: its eps-damped zero block has
    det ~ (lam 1e-12)^3, which underflows f32 to an inf inverse and 0 inf =
    NaN in the solve. Its W and gl are zero, so the identity adds
    nothing."""
    tr = torch.einsum("lii->l", Hll)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    return torch.where((tr > 0)[:, None, None], _damp_blocks(Hll, lam),
                       eye3[None])


def _finish_and_solve_S(S, Hpp_d, b, fixed_mask):
    """Add the damped pose blocks to the off-diagonal Schur mass S (C, 6,
    C, 6), put identity rows and columns on the fixed cameras, and solve
    with ``ops.spd_solve`` (the CUDA kernel on the card). Returns dp
    (C, 6); NaN where S is not positive definite."""
    dtype, device = b.dtype, b.device
    C = b.shape[0]
    ci = torch.arange(C, device=device)
    S = S.clone()
    S[ci, :, ci, :] += Hpp_d
    free = (~fixed_mask).to(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ci, :, ci, :] += (fixed_mask.to(dtype)[:, None, None]
                        * torch.eye(6, dtype=dtype, device=device))
    b = b * free[:, None]
    return spd_solve(S.reshape(6 * C, 6 * C),
                     b.reshape(6 * C).contiguous()).reshape(C, 6)


def lm_gain_update(cost_old, cost_try, lam, nu, dvec, gvec, diag_scaled, bad):
    """``lm_accept`` with the model decrease from flat step, gradient and
    Marquardt-diagonal vectors. Returns (accept, lam_new, nu_new)."""
    pred = 0.5 * torch.dot(dvec, lam * diag_scaled * dvec - gvec)
    return lm_accept(cost_old, cost_try, lam, nu, pred, bad)


def _rhs(gp, gl, W_obs, Hll_inv, lm, cam_table):
    """b = -(gp - W Hll^-1 gl), summed per camera."""
    u = torch.einsum("lij,lj->li", Hll_inv, gl)
    y = torch.einsum("nij,nj->in", W_obs, u[lm])
    return -(gp - table_sum(y, cam_table))


def _back_substitute(dp, W_obs, Hll_inv, gl, cam, lm_table):
    """dl = Hll^-1 (-gl - Wᵀ dp), summed per landmark."""
    t = table_sum(torch.einsum("nij,ni->jn", W_obs, dp[cam]), lm_table)
    return torch.einsum("lij,lj->li", Hll_inv, -gl - t)


def _schur_reduce(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam, n_cams,
                  n_points, fixed_mask, tables=None):
    """The reduced camera system from the whitened block matrix B (3L, 6C):
    with Hll_d = Ld Ldᵀ, W Hll_d^-1 Wᵀ = BᵀB for B[l, c] = Ld^-1 W[c, l]ᵀ,
    so S's off-diagonal mass is one matrix product; rhs and
    back-substitution are sums over observations. `tables` needs its
    block table. Returns (dp (C, 6), dl (L, 3))."""
    if tables is None:
        tables = obs_tables(cam_idx, lm_idx, n_cams, n_points, blocks=True)
    C, L = n_cams, n_points
    N = W_obs.shape[0]
    cam, lm = cam_idx.long(), lm_idx.long()
    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    Ld = cholesky_small(Hll_d)
    X = solve_lower_small(Ld[lm], W_obs.mT)                        # (N, 3, 6)
    B = table_sum(X.reshape(N, 18).T, tables.block)                # (L C, 18)
    B = B.reshape(L, C, 3, 6).permute(0, 2, 1, 3).reshape(3 * L, 6 * C)
    S_off = -(B.T @ B)

    b = _rhs(gp, gl, W_obs, Hll_inv, lm, tables.cam)
    dp = _finish_and_solve_S(S_off.view(C, 6, C, 6), Hpp_d, b, fixed_mask)
    return dp, _back_substitute(dp, W_obs, Hll_inv, gl, cam, tables.lm)


class TrackPairs(NamedTuple):
    """The within-track observation pairs of the paired assembly, as the
    JAX package lays them out: pair_a, pair_b index the observations;
    pair_w is 1 for a < b, 0.5 for a == b (the M + Mᵀ symmetrization
    counts them once) and 0 for padding; (n_chunks, chunk) each."""
    pair_a: torch.Tensor    # int32
    pair_b: torch.Tensor    # int32
    pair_w: torch.Tensor    # dtype


def build_track_pairs(cam_idx, lm_idx, *, chunk=65536, dtype=torch.float32,
                      device=None):
    """Every unordered within-track observation pair (a <= b with
    lm[a] == lm[b]), host side in numpy, O(sum_l k_l² / 2), padded to a
    multiple of `chunk`. Returns a TrackPairs on the observations' device
    (a tensor's own, else `device`, the card unless the caller names
    another)."""
    if device is None and isinstance(cam_idx, torch.Tensor):
        device = cam_idx.device
    device = resolve(device)
    lm_idx = np.asarray(lm_idx.cpu() if isinstance(lm_idx, torch.Tensor)
                        else lm_idx)
    order = np.argsort(lm_idx, kind="stable").astype(np.int32)
    lm_sorted = lm_idx[order]
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    ends = np.r_[starts[1:], lm_sorted.shape[0]]
    lengths = ends - starts
    # bucketed by track length (few distinct lengths)
    a_list, b_list = [], []
    for k in np.unique(lengths):
        if k == 0:
            continue
        tr = np.flatnonzero(lengths == k)
        M = order[starts[tr][:, None] + np.arange(k)[None, :]]
        ii, jj = np.triu_indices(int(k))
        a_list.append(M[:, ii].ravel())
        b_list.append(M[:, jj].ravel())
    pa = np.concatenate(a_list) if a_list else np.zeros(0, np.int32)
    pb = np.concatenate(b_list) if b_list else np.zeros(0, np.int32)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pw = np.where(pa == pb, 0.5, 1.0).astype(np_dtype)
    n = pa.shape[0]
    n_pad = -n % chunk
    if n + n_pad == 0:
        n_pad = chunk
    pa = np.concatenate([pa, np.zeros(n_pad, np.int32)])
    pb = np.concatenate([pb, np.zeros(n_pad, np.int32)])
    pw = np.concatenate([pw, np.zeros(n_pad, np_dtype)])
    t = lambda a: torch.as_tensor(a.reshape(-1, chunk), device=device)  # noqa: E731
    return TrackPairs(pair_a=t(pa), pair_b=t(pb), pair_w=t(pw))


PAIR_TREE = 16      # a block's segment sums added a group, each tree level
PAIR_CHUNK = 2 ** 20    # pairs whose products are formed at once


class PairTables(NamedTuple):
    """The pair sum's fixed order, built once a problem by ``pair_tables``:
    the pairs sorted stably by their block (cam_a, cam_b), cam_a <= cam_b,
    each block's run cut into segments of PAIR_SEGMENT pairs (a == b apart,
    which count half: S's block is M + Mᵀ), each segment padded with the
    zero row; the segments' sums are added a PAIR_TREE-wide group at a
    time, level after level, each level's order a table."""
    a: torch.Tensor        # (n_seg, PAIR_SEGMENT) int64 row ids; pads: n_rows
    b: torch.Tensor        # (n_seg, PAIR_SEGMENT) int64
    seg_w: torch.Tensor    # (n_seg, 1, 1): 0.5 for pairs (a, a), else 1
    levels: tuple          # (n_groups, PAIR_TREE) int64 tables, one a level
    blocks: torch.Tensor   # (n_blocks,) int64 block ids cam_a C + cam_b
    chunk: int             # segments formed at once


def _tree_levels(item_block):
    """The tables that sum the items of each block (item_block sorted) a
    PAIR_TREE-wide group at a time, level after level, until each block
    has one: ([(n_groups, PAIR_TREE) tables], the blocks in order)."""
    levels = []
    while True:
        blocks, counts = torch.unique_consecutive(item_block,
                                                  return_counts=True)
        if not counts.numel() or int(counts.max()) <= 1:
            return levels, blocks
        n = item_block.shape[0]
        per = (counts + PAIR_TREE - 1) // PAIR_TREE
        gstart = torch.cumsum(per, 0) - per
        block_of = torch.repeat_interleave(
            torch.arange(blocks.shape[0], device=blocks.device), counts)
        rank = (torch.arange(n, device=blocks.device)
                - (torch.cumsum(counts, 0) - counts)[block_of])
        table = torch.full((int(per.sum()) * PAIR_TREE,), n,
                           dtype=torch.int64, device=blocks.device)
        table[(gstart[block_of] + rank // PAIR_TREE) * PAIR_TREE
              + rank % PAIR_TREE] = torch.arange(n, device=blocks.device)
        levels.append(table.view(-1, PAIR_TREE))
        item_block = torch.repeat_interleave(blocks, per)


def pair_tables(parts, cam, n_cams, n_rows, dtype=torch.float32,
                chunk=PAIR_CHUNK):
    """The ``PairTables`` of the within-track pairs of rows on cameras cam
    (n_rows,): parts yields them a piece at a time, (a, b) int64 row ids,
    each unordered pair once, a == b included. Each pair is oriented so
    that cam_a <= cam_b, then all are sorted stably by their block.
    chunk: pairs whose products are formed at once."""
    seg = PAIR_SEGMENT
    C = n_cams
    keyed = []
    for a, b in parts:
        ca, cb = cam[a], cam[b]
        swap = ca > cb
        keyed.append((torch.where(swap, b, a), torch.where(swap, a, b),
                      2 * (torch.minimum(ca, cb) * C + torch.maximum(ca, cb))
                      + (a == b)))
    a = torch.cat([p[0] for p in keyed])
    b = torch.cat([p[1] for p in keyed])
    key = torch.cat([p[2] for p in keyed])
    del keyed
    key, order = torch.sort(key, stable=True)
    a, b = a[order], b[order]
    runs, counts = torch.unique_consecutive(key, return_counts=True)
    per = (counts + seg - 1) // seg
    sstart = torch.cumsum(per, 0) - per
    run_of = torch.repeat_interleave(
        torch.arange(runs.shape[0], device=key.device), counts)
    rank = (torch.arange(key.shape[0], device=key.device)
            - (torch.cumsum(counts, 0) - counts)[run_of])
    n_seg = int(per.sum())
    dest = sstart[run_of] * seg + rank
    seg_a = torch.full((n_seg * seg,), n_rows, dtype=torch.int64,
                       device=key.device)
    seg_b = seg_a.clone()
    seg_a[dest], seg_b[dest] = a, b
    seg_key = torch.repeat_interleave(runs, per)
    seg_w = torch.where(seg_key % 2 == 1, 0.5, 1.0).to(dtype)
    levels, blocks = _tree_levels(seg_key // 2)
    return PairTables(a=seg_a.view(n_seg, seg), b=seg_b.view(n_seg, seg),
                      seg_w=seg_w.view(n_seg, 1, 1), levels=tuple(levels),
                      blocks=blocks, chunk=max(chunk // seg, 1))


def pair_mass(A, B, pairs: PairTables, n_cams, dtype=None):
    """M (C, C, P, P): M[cam_a, cam_b] = the sum over the pairs (a, b) of
    w A_aᵀ B_b, from rows A, B (n_rows + 1, r, P) whose last row is zero,
    a chunk of segments at a time (peak memory O(chunk), whatever the
    problem), each segment one (P x r 64)(r 64 x P) product in A's dtype,
    the segments' sums added in `dtype` (default A's) in the tables' fixed
    order. S's off-diagonal mass is M + Mᵀ."""
    C = n_cams
    r, P = A.shape[1:]
    rows = r * PAIR_SEGMENT
    n_seg = pairs.a.shape[0]
    partial = A.new_empty((n_seg, P * P), dtype=dtype or A.dtype)
    fa, fb = A.reshape(-1, r * P), B.reshape(-1, r * P)
    for s0 in range(0, n_seg, pairs.chunk):
        s1 = min(s0 + pairs.chunk, n_seg)
        Xa = fa[pairs.a[s0:s1].reshape(-1)].view(s1 - s0, rows, P)
        Xb = fb[pairs.b[s0:s1].reshape(-1)].view(s1 - s0, rows, P)
        partial[s0:s1] = (torch.bmm(Xa.transpose(1, 2), Xb)
                          * pairs.seg_w[s0:s1]).view(s1 - s0, P * P)
    items = partial
    for table in pairs.levels:
        items = torch.cat([items, items.new_zeros((1, P * P))])[table].sum(1)
    M = partial.new_zeros((C * C, P * P))
    M[pairs.blocks] = items
    return M.view(C, C, P, P)


def pair_segments(pairs: TrackPairs, cam_idx, n_cams):
    """The ``PairTables`` of the live pairs of `pairs` (weight > 0) over
    observations on cameras cam_idx."""
    live = pairs.pair_w.reshape(-1) > 0
    return pair_tables([(pairs.pair_a.reshape(-1)[live].long(),
                         pairs.pair_b.reshape(-1)[live].long())],
                       cam_idx.long(), n_cams, cam_idx.shape[0],
                       pairs.pair_w.dtype, pairs.pair_a.shape[1])


def _paired_S_mass(Y, W_obs, segs: PairTables, n_cams):
    """The unsymmetrized off-diagonal Schur mass M[cam_a, cam_b] = sum of
    w Y[a] W[b]ᵀ over the within-track pairs (``pair_mass`` of Yᵀ and
    Wᵀ). Returns M (C, C, 6, 6); S_off = -(M + M^T_blocks)."""
    zero = Y.new_zeros((1, 3, 6))
    return pair_mass(torch.cat([Y.mT, zero]), torch.cat([W_obs.mT, zero]),
                     segs, n_cams)


def _schur_reduce_paired(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam,
                         n_cams, n_points, fixed_mask, pairs: TrackPairs,
                         tables=None, segs=None):
    """The exact reduced camera system without the dense block matrix:
    M[cam_a, cam_b] += w (W_a Hll_d^-1) W_bᵀ over each track's pairs
    a <= b, S_off = -(M + M^T_blocks); compute O(sum_l k_l²), memory O(N).
    Returns (dp (C, 6), dl (L, 3))."""
    if tables is None:
        tables = obs_tables(cam_idx, lm_idx, n_cams, n_points)
    if segs is None:
        segs = pair_segments(pairs, cam_idx, n_cams)
    cam, lm = cam_idx.long(), lm_idx.long()
    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_d = _damp_hll(Hll, lam)
    Hll_inv = _inv3x3(Hll_d)

    Y = torch.einsum("nij,njk->nik", W_obs, Hll_inv[lm])          # (N, 6, 3)
    M = _paired_S_mass(Y, W_obs, segs, n_cams)
    S_off = -(M + M.permute(1, 0, 3, 2)).permute(0, 2, 1, 3)      # (C,6,C,6)

    b = _rhs(gp, gl, W_obs, Hll_inv, lm, tables.cam)
    dp = _finish_and_solve_S(S_off, Hpp_d, b, fixed_mask)
    return dp, _back_substitute(dp, W_obs, Hll_inv, gl, cam, tables.lm)


def solve_ba(poses0, points0, obs, *, fixed_mask=None, max_iters=30,
             lambda_init=1e-4, xtol=1e-12, gtol=0.0, linear_solver="dense",
             cg_iters=100, cg_tol=1e-8, loss=None, callback=None,
             track_pairs=None, band_pairs=None, track_table=None,
             costs=None):
    """LM bundle adjustment over the observation list `obs` (cam_idx,
    lm_idx, uv, weight); the same iteration as the JAX package's
    ``solve_ba``. Returns a BAState.

    linear_solver: "dense" forms the reduced camera system exactly (small
    and medium C); "pcg" runs matrix-free block-Jacobi PCG (with
    `band_pairs=pcg.build_band_pairs(...)`, the block-tridiagonal
    preconditioner); "paired" is the exact solve with O(N) memory, pass
    `track_pairs=build_track_pairs(obs.cam_idx, obs.lm_idx)`; "tracks" takes
    `track_table=build_track_table(obs.cam_idx, obs.lm_idx, obs.weight,
    n_points=L)`, as the JAX package's does, and runs the dense solve. loss: a ``residuals.robust.Loss`` (IRLS: each
    linearization scales the weights by weight(‖r‖²), the cost is
    0.5 w rho(‖r‖²)) or None. gtol > 0 also stops after a step taken where
    the gradient's largest magnitude was below gtol. callback(it, cost,
    lam) after each step; `costs` as in ``lm_loop``."""
    robust.check(loss)
    if linear_solver not in ("dense", "paired", "tracks", "pcg"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    if linear_solver == "tracks" and track_table is None:
        raise ValueError("linear_solver='tracks' requires track_table="
                         "build_track_table(obs.cam_idx, obs.lm_idx, "
                         "obs.weight, n_points=L)")
    if linear_solver == "paired" and track_pairs is None:
        raise ValueError("linear_solver='paired' requires track_pairs="
                         "build_track_pairs(obs.cam_idx, obs.lm_idx)")
    set_full_precision()
    C, L = poses0.t.shape[0], points0.shape[0]
    device = points0.device
    cam_idx, lm_idx, uv, base_w = obs.cam_idx, obs.lm_idx, obs.uv, obs.weight
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(C, device)
    # every fixed summation order, before the loop
    tables = obs_tables(cam_idx, lm_idx, C, L, base_w,
                        blocks=linear_solver in ("dense", "tracks"))
    segs = (pair_segments(track_pairs, cam_idx, C)
            if linear_solver == "paired" else None)
    if linear_solver == "pcg":
        from slam_tricks_tpu_torch.solvers import pcg
        btables = (None if band_pairs is None
                   else pcg.band_tables(band_pairs, cam_idx, C))

    def quantities(poses, points):
        if loss is None:
            w = base_w
            cost = _cost(poses, points, cam_idx, lm_idx, uv, base_w)
        else:
            r = _residuals(poses, points, cam_idx, lm_idx, uv)
            s = torch.sum(r * r, dim=1)
            w = base_w * loss.weight(s)
            cost = 0.5 * torch.sum(base_w * loss.rho(s))
        r, Jp, Jl = _linearize_obs(poses, points, cam_idx, lm_idx, uv, w)
        return _assemble(r, Jp, Jl, cam_idx, lm_idx, C, L, tables), cost

    def solve(blocks, lam):
        Hpp, Hll, gp, gl, W_obs = blocks
        if linear_solver in ("dense", "tracks"):
            dp, dl = _schur_reduce(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx,
                                   lam, C, L, fixed_mask, tables)
        elif linear_solver == "paired":
            dp, dl = _schur_reduce_paired(Hpp, Hll, gp, gl, W_obs, cam_idx,
                                          lm_idx, lam, C, L, fixed_mask,
                                          track_pairs, tables, segs)
        else:
            dp, dl = pcg.solve_rcs_pcg(
                Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam, fixed_mask, L,
                cg_iters=cg_iters, cg_tol=cg_tol, band_pairs=band_pairs,
                tables=tables, band_tables=btables)
        diag_pp = torch.clamp_min(torch.diagonal(Hpp, dim1=-2, dim2=-1), 1e-12)
        diag_ll = torch.clamp_min(torch.diagonal(Hll, dim1=-2, dim2=-1), 1e-12)
        return dp, dl, diag_pp, diag_ll

    return lm_loop(poses0, points0, quantities, solve, max_iters=max_iters,
                   lambda_init=lambda_init, xtol=xtol, gtol=gtol,
                   costs=costs, callback=callback,
                   grads=lambda blocks: (blocks[2], blocks[3]))
