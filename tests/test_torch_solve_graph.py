"""The port's garment surface solve (``core/surface_ps.SurfaceSolver``) and
the embedder's bands made once.

On the CPU the solver runs its iteration eagerly; it must give the bits of
the closure-based loop it replaced (a frozen copy here, on
``make_deform_fn``'s closure): the same arithmetic with the skinning
transforms, translations and latents gathered once per solve. The cache's
rule (capture a key at its second solve, keep the ``GRAPHS`` most recently
used) and its key (a replaced tensor is a new key, an in-place update is
not) are checked without a card.

Tests marked ``gpu`` need a CUDA device and skip without one: the captured
iteration against the eager one, after an in-place optimizer update too,
new captures for a new shape or a replaced parameter, and a replay with no
host synchronization. This file imports no JAX.
"""

import math

import pytest
import torch

from recmv_tpu_torch.core.surface_ps import GRAPHS, DTHRESHOLD, MAX_STEP, W1, W2, SurfaceSolver
from recmv_tpu_torch.models.garment_model import make_deform_fn
from recmv_tpu_torch.models.sdf import init_sdf_net, sdf_value
from recmv_tpu_torch.models.skinner import SkinnerParams, init_pose_inverse, skinning_transforms
from recmv_tpu_torch.models.smpl import SMPL_PARENTS
from recmv_tpu_torch.models.translator import init_translator
from recmv_tpu_torch.ops.embedder import Embedder, annealing_weights
from recmv_tpu_torch.ops.math3d import batch_rodrigues
from recmv_tpu_torch.utils import profiling

CAM = (0.0, 0.0, -3.0)


@pytest.fixture(autouse=True)
def _off():
    profiling.disable()
    profiling.counters()
    yield
    profiling.disable()
    profiling.counters()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frozen_optimize_surface_points(sdf_fn, deform_fn, cam_origin, rays, init_pts, valid,
                                   athreshold_deg=0.02, times=20, dthreshold=DTHRESHOLD):
    """The closure-based solve as it was before the garment solver, less
    its spans and counters: the plain reference."""

    def eval_at(pts):
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            l1 = torch.abs(sdf_fn(p))
            direct = deform_fn(p) - cam_origin
            up = torch.cross(direct, rays, dim=-1)
            s = torch.linalg.norm(up, dim=-1) / torch.clamp(
                torch.linalg.norm(direct, dim=-1), min=1e-12)
            losses = W1 * l1 + W2 * torch.abs(s)
            (grads,) = torch.autograd.grad(losses.sum(), p)
        ang = torch.arcsin(torch.clamp(s.detach(), 0.0, 1.0)) * 180.0 / math.pi
        conv = (l1.detach() < dthreshold) & (ang < athreshold_deg)
        return losses.detach(), grads, conv

    pts = init_pts.detach()
    unfinished = valid.clone()
    it = 0
    while it <= times:
        if not bool(unfinished.any()):
            break
        losses, grads, conv = eval_at(pts)
        unfinished = unfinished & ~conv
        gg = torch.sum(grads * grads, -1)
        ok = gg > 1e-12
        t = torch.where(ok, -losses / torch.where(ok, gg, 1.0), 0.0)
        step = t[:, None] * grads
        slen = torch.linalg.norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp(MAX_STEP / torch.clamp(slen, min=1e-12), max=1.0)
        new_pts = pts + step
        finite = torch.isfinite(new_pts).all(-1)
        pts = torch.where((unfinished & finite)[:, None], new_pts, pts)
        unfinished = unfinished & finite
        it += 1
    pts = torch.where(torch.isfinite(pts), pts, 0.0)
    return pts, valid & ~unfinished, it


def make_problem(seed=0, n_frames=1, M=48, missed=0, device="cpu"):
    """A small garment SDF (about a sphere of radius 0.5), the translator
    (condlen 8), a random skinner, frames of small poses, and M rows whose
    seeds lie near the sphere on rays through their deformed seeds; the
    first ``missed`` rays are turned off the surface, and rows 0 mod 7 are
    invalid."""
    gen = torch.Generator().manual_seed(seed)
    gsdf = init_sdf_net(gen, 6, 0.5, 16, dims=(64,) * 4, skip_in=(2,))
    translator = init_translator(gen, condlen=8, multires=4)
    Js = 0.2 * torch.randn(24, 3, generator=gen)
    sk = SkinnerParams(
        ws=torch.softmax(torch.randn(24, 9, 13, 9, generator=gen), 0), Js=Js,
        init_pose_inv=init_pose_inverse(batch_rodrigues(0.1 * torch.randn(24, 3, generator=gen)),
                                        Js, SMPL_PARENTS),
        extra_trans=0.01 * torch.randn(1, 3, generator=gen), bbox_center=torch.zeros(3),
        bbox_extend=torch.tensor(2.5), b_min=-torch.ones(3), b_max=torch.ones(3))
    frames = dict(cond=torch.randn(n_frames, 8, generator=gen),
                  poses=0.1 * torch.randn(n_frames, 24, 3, generator=gen),
                  trans=0.02 * torch.randn(n_frames, 3, generator=gen))
    dirs = torch.nn.functional.normalize(torch.randn(M, 3, generator=gen), dim=-1)
    dirs[:, 2] = -dirs[:, 2].abs()                      # the side facing the camera
    seeds = dirs * (0.5 + 0.01 * torch.randn(M, 1, generator=gen))
    batch_inds = torch.randint(0, n_frames, (M,), generator=gen)
    valid = torch.arange(M) % 7 != 0
    gsdf, translator, sk = gsdf.to(device), translator.to(device), sk.to(device)
    frames = {k: v.to(device) for k, v in frames.items()}
    seeds, batch_inds, valid = seeds.to(device), batch_inds.to(device), valid.to(device)
    cam = torch.tensor(CAM, device=device)
    with torch.no_grad():
        hit = _deform(translator, sk, frames, 0.5, batch_inds)(seeds)
        rays = torch.nn.functional.normalize(hit - cam, dim=-1)
        rays[:missed] = torch.nn.functional.normalize(
            rays[:missed] + torch.tensor([0.6, 0.0, 0.0], device=device), dim=-1)
    return dict(gsdf=gsdf, translator=translator, sk=sk, frames=frames, cam=cam, rays=rays,
                seeds=seeds, valid=valid, batch_inds=batch_inds)


def _deform(translator, sk, frames, ratio, batch_inds):
    return make_deform_fn({"translator": translator, "skinner": sk}, frames["cond"],
                          frames["poses"], frames["trans"], ratio, batch_inds=batch_inds)


def reference_solve(pb, ratios, **kw):
    f = pb["frames"]
    return frozen_optimize_surface_points(
        lambda p: sdf_value(pb["gsdf"], p, ratios[0]),
        _deform(pb["translator"], pb["sk"], f, ratios[1], pb["batch_inds"]),
        pb["cam"], pb["rays"], pb["seeds"], pb["valid"], **kw)


def garment_solve(solver, pb, ratios, **kw):
    f, sk = pb["frames"], pb["sk"]
    with torch.no_grad():
        return solver.solve(pb["gsdf"], pb["translator"], sk, pb["cam"], pb["rays"],
                            pb["seeds"], pb["valid"], pb["batch_inds"], f["cond"],
                            skinning_transforms(sk, f["poses"]), f["trans"] + sk.extra_trans,
                            ratios, **kw)


CASES = {
    # name: (problem, ratios (sdfRatio, deformerRatio), solve thresholds)
    "one_frame": (dict(seed=0), (1.0, 0.5), dict(athreshold_deg=2.0, dthreshold=1e-2)),
    "three_frames": (dict(seed=1, n_frames=3), (None, 0.3),
                     dict(athreshold_deg=2.0, dthreshold=1e-2)),
    "some_never_converge": (dict(seed=2, n_frames=2, missed=20), (0.8, 0.5),
                            dict(athreshold_deg=2.0, dthreshold=1e-2)),
    "stops_after_one": (dict(seed=3, n_frames=2), (1.0, 0.5),
                        dict(athreshold_deg=180.0, dthreshold=10.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_solver_gives_the_closure_loops_bits(case):
    problem, ratios, kw = CASES[case]
    pb = make_problem(**problem)
    want_pts, want_conv, evals = reference_solve(pb, ratios, times=20, **kw)
    profiling.enable()
    pts, conv = garment_solve(SurfaceSolver(), pb, ratios, times=20, **kw)
    profiling.disable()
    c = profiling.counters()
    assert torch.equal(pts, want_pts) and torch.equal(conv, want_conv)
    assert c["solve.evals"] == c["solve.eager_evals"] == evals
    assert "solve.graph_captures" not in c and "solve.graph_replays" not in c
    n_valid, n_conv = int(pb["valid"].sum()), int(conv.sum())
    if case == "stops_after_one":
        assert evals == 1 and n_conv == n_valid
    elif case == "some_never_converge":
        assert evals == 21 and 0 < n_conv < n_valid
        assert not conv[:20].any()
    else:
        assert n_conv > n_valid // 2


def test_embedder_bands_are_made_once_with_the_same_bits():
    emb = Embedder(6)
    x = torch.randn(10, 3, generator=torch.Generator().manual_seed(0))
    ws = annealing_weights(6, 0.4)

    def frozen(x, ws=None):
        freqs = torch.tensor(emb.freq_bands, dtype=x.dtype, device=x.device)
        xf = x[..., None, :] * freqs[:, None]
        enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
        if ws is not None:
            enc = enc * torch.as_tensor(ws, dtype=enc.dtype).reshape(6, 2)[..., None]
        return torch.cat([x, enc.reshape(x.shape[:-1] + (36,))], dim=-1)

    assert torch.equal(emb(x, ws), frozen(x, ws))
    bands = emb._freqs[x.device, x.dtype]
    assert torch.equal(emb(3.0 * x), frozen(3.0 * x))
    assert emb._freqs[x.device, x.dtype] is bands and len(emb._freqs) == 1
    x64 = x.double()
    assert torch.equal(emb(x64, ws), frozen(x64, ws)) and len(emb._freqs) == 2


def test_cache_captures_a_key_at_its_second_solve_and_keeps_the_latest():
    """``_rows``' bookkeeping, with keys naming a CUDA device (nothing is
    captured here: ``capture`` only marks the rows)."""

    class Rows:
        capture = False

    def key(i, dev="cuda"):
        return (i, torch.float32, torch.device(dev))

    solver = SurfaceSolver()
    first = solver._rows(key(0), Rows)
    assert not first.capture and key(0) in solver.seen and not solver.graphs
    second = solver._rows(key(0), Rows)
    assert second is not first and second.capture and list(solver.graphs) == [key(0)]
    assert solver._rows(key(0), Rows) is second and key(0) not in solver.seen
    for _ in range(2):                                   # the CPU never captures
        assert not solver._rows(key(9, "cpu"), Rows).capture
    for i in range(1, GRAPHS + 1):
        solver._rows(key(i), Rows)
        if i == GRAPHS:
            solver._rows(key(0), Rows)                   # key 0 the most recent again
        solver._rows(key(i), Rows)
    assert list(solver.graphs) == [key(i) for i in (2, 3, 0, 4)]   # key 1 dropped
    solver.eager_only = True
    solver._rows(key(7), Rows)
    assert not solver._rows(key(7), Rows).capture


def test_key_follows_replaced_tensors_not_in_place_updates():
    pb = make_problem()
    nets = (pb["gsdf"], pb["translator"], pb["sk"])
    key = SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-3, (12, 8))
    with torch.no_grad():
        for p in pb["gsdf"].parameters():
            p.add_(0.01)
    assert SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-3, (12, 8)) == key
    assert SurfaceSolver.key(nets, pb["rays"][:-1], 0.5, 1e-3, (12, 8)) != key
    assert SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-4, (12, 8)) != key
    assert SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-3, (None, 8)) != key
    lin = pb["gsdf"].lins[0]
    lin.b = torch.nn.Parameter(lin.b.detach().clone())
    assert SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-3, (12, 8)) != key
    sk = pb["sk"]
    sk.ws = sk.ws.clone()
    nets = (pb["gsdf"], pb["translator"], sk)
    assert SurfaceSolver.key(nets, pb["rays"], 0.5, 1e-3, (12, 8)) != key


# --- on the card ---------------------------------------------------------

KW = dict(athreshold_deg=2.0, dthreshold=1e-2, times=20)
RATIOS = (1.0, 0.5)


def _close(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[0], want[0], rtol=0.0, atol=1e-6), (got[0] - want[0]).abs().max()


def _eager(pb):
    solver = SurfaceSolver()
    solver.eager_only = True
    return garment_solve(solver, pb, RATIOS, **KW)


@pytest.mark.gpu
def test_graphed_solve_matches_eager_on_the_card(cuda):
    pb = make_problem(seed=4, n_frames=3, M=512, missed=64, device=cuda)
    want = _eager(pb)
    solver = SurfaceSolver()
    profiling.enable()
    got = [garment_solve(solver, pb, RATIOS, **KW) for _ in range(3)]
    profiling.disable()
    c = profiling.counters()
    for g in got:
        _close(g, want)
    assert 0 < int(want[1].sum()) < int(pb["valid"].sum())
    assert c["solve.graph_captures"] == 1
    assert c["solve.eager_evals"] == c["solve.evals"] / 3 == c["solve.graph_replays"] / 2


@pytest.mark.gpu
def test_replay_reads_an_in_place_optimizer_update(cuda):
    pb = make_problem(seed=5, n_frames=2, M=256, device=cuda)
    solver = SurfaceSolver()
    for _ in range(2):
        before = garment_solve(solver, pb, RATIOS, **KW)
    opt = torch.optim.Adam(pb["gsdf"].parameters(), lr=1e-3)
    x = torch.randn(128, 3, device=cuda)
    (sdf_value(pb["gsdf"], x, 1.0) - 0.3).square().sum().backward()
    opt.step()
    profiling.enable()
    got = garment_solve(solver, pb, RATIOS, **KW)
    profiling.disable()
    c = profiling.counters()
    assert c.get("solve.graph_replays", 0) == c["solve.evals"] and "solve.eager_evals" not in c
    want = _eager(pb)
    _close(got, want)
    assert not torch.equal(got[0], before[0])


@pytest.mark.gpu
def test_new_rows_or_a_replaced_parameter_capture_again(cuda):
    pb = make_problem(seed=6, M=256, device=cuda)
    solver = SurfaceSolver()

    def captures(pb, n=2):
        profiling.enable()
        for _ in range(n):
            garment_solve(solver, pb, RATIOS, **KW)
        profiling.disable()
        return profiling.counters().get("solve.graph_captures", 0)

    assert captures(pb) == 1
    assert captures(pb) == 0
    fewer = dict(pb, rays=pb["rays"][:200], seeds=pb["seeds"][:200], valid=pb["valid"][:200],
                 batch_inds=pb["batch_inds"][:200])
    assert captures(fewer) == 1
    lin = pb["gsdf"].lins[1]
    lin.b = torch.nn.Parameter(lin.b.detach().clone())
    assert captures(pb) == 1
    _close(garment_solve(solver, pb, RATIOS, **KW), _eager(pb))


@pytest.mark.gpu
def test_a_replay_makes_no_host_sync(cuda):
    pb = make_problem(seed=7, M=256, device=cuda)
    solver = SurfaceSolver()
    for _ in range(2):
        garment_solve(solver, pb, RATIOS, **KW)
    (rows,) = solver.graphs.values()
    assert rows.graph is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver._step(rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
