"""Surface-point root finding and its implicit adjoint (counterpart of
``recmv_tpu/core/surface_ps.py``).

- ``optimize_surface_points``: per-ray projected Newton steps on canonical
  points p minimizing w1·|sdf(p)| + w2·sin∠(ray, D(p) − cam), with an
  "unfinished" mask in place of the reference's shrinking tensors.
- ``SurfaceSolver``: the same solve for one garment's SDF and the
  deformer, on rows whose frame is gathered once per solve; on CUDA it
  replays each iteration as one captured CUDA graph.
- ``attach_implicit_surface``: the solved points come from a solver that
  is not differentiated, so ∂L/∂p* reaches the parameters θ through the
  constraints F(p; θ) = [sdf(p); ray × (D(p) − cam)] = 0: with B = ∂F/∂p
  (4×3), dL/dθ = −g (BᵀB)⁻¹Bᵀ ∂F/∂θ (the JAX
  ``make_implicit_surface_adjoint``, a ``jax.custom_vjp``).
"""

from __future__ import annotations

import math
import sys
from collections import OrderedDict

import torch

from ..models.sdf import sdf_layers
from ..models.skinner import skin_rows
from ..models.translator import translator_layers
from ..ops.embedder import ratio_weights
from ..ops.math3d import fast_3x3_inv
from ..utils.profiling import count, span

MAX_STEP = 0.05      # canonical units per Newton step (trust region)
DTHRESHOLD = 5e-5    # |sdf| bound of a converged point
W1, W2 = 3.05, 1.0   # loss weights of |sdf| and sin∠
GRAPHS = 4           # captured iterations a garment keeps, the least recently used dropped
SEEN = 16            # keys a garment remembers having solved once
WARMUP = 2           # eager iterations on the capture stream before a capture


def newton_iteration(sdf_fn, deform_fn, cam_origin, rays, pts, unfinished,
                     athreshold_deg: float, dthreshold: float):
    """One evaluation of the rows and their projected Newton step, in place:
    ``pts`` (M, 3) and ``unfinished`` (M,) take the step's values (rows
    that converged at this evaluation, or whose step is not finite, stop).
    Returns the evaluation's (losses, grads, conv)."""
    with span("solve/eval"):
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            l1 = torch.abs(sdf_fn(p))
            direct = deform_fn(p) - cam_origin
            up = torch.cross(direct, rays, dim=-1)
            s = torch.linalg.norm(up, dim=-1) / torch.clamp(
                torch.linalg.norm(direct, dim=-1), min=1e-12)
            losses = W1 * l1 + W2 * torch.abs(s)
            (grads,) = torch.autograd.grad(losses.sum(), p)
        losses = losses.detach()
        ang = torch.arcsin(torch.clamp(s.detach(), 0.0, 1.0)) * 180.0 / math.pi
        conv = (l1.detach() < dthreshold) & (ang < athreshold_deg)
    with span("solve/step"):
        live = unfinished & ~conv
        gg = torch.sum(grads * grads, -1)
        ok = gg > 1e-12
        t = torch.where(ok, -losses / torch.where(ok, gg, 1.0), 0.0)
        step = t[:, None] * grads
        slen = torch.linalg.norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp(MAX_STEP / torch.clamp(slen, min=1e-12), max=1.0)
        new_pts = pts + step
        finite = torch.isfinite(new_pts).all(-1)
        pts.copy_(torch.where((live & finite)[:, None], new_pts, pts))
        unfinished.copy_(live & finite)
    return losses, grads, conv


def _newton_loop(iterate, unfinished, times: int) -> None:
    """Up to ``times`` + 1 iterations, stopping early once no row is left
    unfinished (the host's one read an iteration)."""
    it = 0
    while it <= times:
        with span("solve/check"):
            if not bool(unfinished.any()):
                break
        count("solve.live", lambda: unfinished.clone())    # the buffer changes in place
        iterate()
        it += 1
    count("solve.calls")
    count("solve.evals", it)
    count("solve.rows", it * unfinished.shape[0])


def _finish(pts, unfinished, valid):
    with span("solve/finish"):
        return torch.where(torch.isfinite(pts), pts, 0.0), valid & ~unfinished


def optimize_surface_points(sdf_fn, deform_fn, cam_origin, rays, init_pts, valid,
                            athreshold_deg: float = 0.02, times: int = 20,
                            dthreshold: float = DTHRESHOLD):
    """Refine canonical surface points along fixed rays.

    sdf_fn (M, 3) → (M,); deform_fn (M, 3) → (M, 3), both closed over
    parameters and per-point frames; cam_origin (3,), rays (M, 3) world
    unit rays, init_pts (M, 3) seeds, valid (M,) live rays.
    Returns (pts, converged ⊆ valid); pts carry no graph.

    A point converges when |sdf| < dthreshold and its angle to the ray is
    below athreshold_deg, checked before each step; at most times + 1
    evaluations run, stopping early once no point is left unfinished.

    Traced (``utils.profiling``): spans ``solve/setup``, ``solve/check``
    (the host's read of the stop test), ``solve/eval`` (the SDF and the
    deformation and their gradient), ``solve/step`` (the projected
    update) and ``solve/finish``; counters ``solve.calls``,
    ``solve.evals``, ``solve.eager_evals``, ``solve.rows`` (rows
    evaluated) and ``solve.live`` (rows valid and unfinished as each
    evaluation starts)."""
    with span("solve/setup"):
        pts = init_pts.detach().clone()
        unfinished = valid.clone()

    def iterate():
        newton_iteration(sdf_fn, deform_fn, cam_origin, rays, pts, unfinished,
                         athreshold_deg, dthreshold)
        count("solve.eager_evals")

    _newton_loop(iterate, unfinished, times)
    return _finish(pts, unfinished, valid)


class _Rows:
    """The static rows of one garment's solve at one shape: what an
    iteration reads (rays, the rows' latents, skinning transforms and
    translations, the camera, the embedders' band weights) and the points
    and mask it updates in place; once captured, the iteration's graph."""

    def __init__(self, M, cond_dim, sdf_bands, def_bands, athreshold_deg, dthreshold, like):
        f = dict(dtype=like.dtype, device=like.device)
        self.pts = torch.zeros(M, 3, **f)
        self.rays = torch.zeros(M, 3, **f)
        self.unfinished = torch.zeros(M, dtype=torch.bool, device=like.device)
        self.cond = torch.zeros(M, cond_dim, **f)
        self.A = torch.zeros(M, 24, 4, 4, **f)
        self.trans = torch.zeros(M, 3, **f)
        self.origin = torch.zeros(3, **f)
        self.sdf_ws = None if sdf_bands is None else torch.zeros(sdf_bands, **f)
        self.def_ws = None if def_bands is None else torch.zeros(def_bands, **f)
        self.thresholds = (athreshold_deg, dthreshold)
        self.nets = None
        self.graph = None
        self.outputs = None            # the graph's (losses, grads, conv), kept with it
        self.capture = False           # capture before the next iteration

    def load(self, nets, cam_origin, rays, init_pts, valid, batch_inds, cond, A, trans,
             sdf_ws, def_ws):
        self.nets = nets
        self.pts.copy_(init_pts)
        self.rays.copy_(rays)
        self.unfinished.copy_(valid)
        torch.index_select(cond, 0, batch_inds, out=self.cond)
        torch.index_select(A, 0, batch_inds, out=self.A)
        torch.index_select(trans, 0, batch_inds, out=self.trans)
        self.origin.copy_(cam_origin)
        for buf, ws in ((self.sdf_ws, sdf_ws), (self.def_ws, def_ws)):
            if buf is not None:
                buf.copy_(ws)

    def iterate(self):
        """One iteration, eagerly: the garment SDF, the translator's offset
        and LBS on the gathered rows (``make_deform_fn``'s flat path)."""
        sdf_net, translator, sk = self.nets

        def sdf_fn(p):
            x = p if sdf_net.embedder is None else sdf_net.embedder(p, self.sdf_ws)
            return sdf_layers(sdf_net, x)[0]

        def deform_fn(p):
            x = p if translator.embedder is None else translator.embedder(p, self.def_ws)
            off = translator_layers(translator, torch.cat([x, self.cond], dim=-1))
            return skin_rows(sk, p + off, self.A, self.trans)

        return newton_iteration(sdf_fn, deform_fn, self.origin, self.rays, self.pts,
                                self.unfinished, *self.thresholds)

    def capture_on(self, stream) -> None:
        """Warm up on ``stream``, then capture one iteration there; the
        points and mask are put back as they were."""
        saved = self.pts.clone(), self.unfinished.clone()
        current = torch.cuda.current_stream(self.pts.device)
        try:
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                for _ in range(WARMUP):
                    self.iterate()
            current.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self.outputs = self.iterate()
            self.graph = graph
        finally:
            self.pts.copy_(saved[0])
            self.unfinished.copy_(saved[1])


class SurfaceSolver:
    """One garment's surface solve, ``optimize_surface_points`` on the
    garment SDF and the deformer (``make_deform_fn``'s flat path), with
    what does not change between iterations moved out of them: each row's
    skinning transforms, translation and latent are gathered once per
    solve into static buffers, and the embedders' band weights for the
    step's ratios are made once per solve.

    On CUDA an iteration (the evaluation, its gradient with respect to
    the points and the projected step) reads and writes only those
    buffers, the parameters and the skinner, so it is captured as one
    CUDA graph and replayed, one launch an iteration; the stop test stays
    on the host. A graph is keyed on what it reads by address and what it
    bakes in: the rows, dtype and device, the parameters' and the
    skinner's storage (a replaced tensor is a new key, so no stale weight
    is replayed; in-place updates are read), whether the bands are
    weighted, and the thresholds. A key is captured when it is solved the
    second time (the first runs eagerly, so one-off shapes cost no
    capture), and at most ``GRAPHS`` are kept. Where a capture raises, the
    solver says so on stderr and stays eager from then on. On the CPU
    every iteration is eager. Counters: ``solve.graph_captures``,
    ``solve.graph_replays``, ``solve.eager_evals``, besides
    ``optimize_surface_points``'s."""

    def __init__(self):
        self.graphs = OrderedDict()     # key → _Rows, least recently used first
        self.seen = OrderedDict()       # keys solved once
        self.stream = None
        self.eager_only = False

    @staticmethod
    def key(nets, rays, athreshold_deg, dthreshold, bands):
        sdf_net, translator, sk = nets
        ptrs = tuple(t.data_ptr() for net in (sdf_net, translator) for t in net.parameters())
        return (rays.shape[0], rays.dtype, rays.device, ptrs, sk.ws.data_ptr(),
                sk.bbox_center.data_ptr(), sk.bbox_extend.data_ptr(), bands,
                float(athreshold_deg), float(dthreshold))

    def _rows(self, key, make):
        """The static rows for ``key``: a kept graph's, or new ones, marked
        for capture when the key was solved before."""
        rows = self.graphs.get(key)
        if rows is not None:
            self.graphs.move_to_end(key)
            return rows
        rows = make()
        cuda = key[2].type == "cuda"
        if cuda and not self.eager_only and key in self.seen:
            del self.seen[key]
            rows.capture = True
            self.graphs[key] = rows
            while len(self.graphs) > GRAPHS:
                self.graphs.popitem(last=False)
        else:
            self.seen[key] = None
            self.seen.move_to_end(key)
            while len(self.seen) > SEEN:
                self.seen.popitem(last=False)
        return rows

    def _step(self, rows):
        if rows.capture:
            rows.capture = False
            try:
                if self.stream is None:
                    self.stream = torch.cuda.Stream(rows.pts.device)
                rows.capture_on(self.stream)
                count("solve.graph_captures")
            except Exception as e:                 # noqa: BLE001 - the eager path stays right
                self.eager_only = True
                rows.graph = None
                sys.stderr.write(f"surface solve: capturing an iteration as a CUDA graph "
                                 f"failed ({type(e).__name__}: {e}); this garment now solves "
                                 "eagerly\n")
        if rows.graph is not None:
            with span("solve/eval"):
                rows.graph.replay()
            count("solve.graph_replays")
        else:
            rows.iterate()
            count("solve.eager_evals")

    def solve(self, sdf_net, translator, skinner, cam_origin, rays, init_pts, valid,
              batch_inds, cond, A, trans, ratios, athreshold_deg: float = 0.02,
              times: int = 20, dthreshold: float = DTHRESHOLD):
        """``optimize_surface_points`` for the garment SDF ``sdf_net`` under
        the deformer (``translator``, ``skinner``): rays, init_pts (M, 3)
        and valid (M,) as there; row m in frame batch_inds[m] of cond (N,
        condlen) latents, A (N, 24, 4, 4) skinning transforms
        (``skinning_transforms``) and trans (N, 3) translations with the
        skinner's extra translation added; ratios (sdfRatio,
        deformerRatio). Returns (pts, converged ⊆ valid), the same bits as
        ``optimize_surface_points`` on ``make_deform_fn``'s closure."""
        nets = (sdf_net, translator, skinner)
        with span("solve/setup"), torch.no_grad():
            sdf_ws, def_ws = (None if net.embedder is None else
                              ratio_weights(net.embedder, ratio, rays.device)
                              for net, ratio in zip(nets[:2], ratios))
            bands = tuple(None if w is None else w.shape[0] for w in (sdf_ws, def_ws))
            key = self.key(nets, rays, athreshold_deg, dthreshold, bands)
            rows = self._rows(key, lambda: _Rows(rays.shape[0], cond.shape[-1], *bands,
                                                 float(athreshold_deg), float(dthreshold),
                                                 rays))
            rows.load(nets, cam_origin, rays, init_pts, valid, batch_inds, cond, A, trans,
                      sdf_ws, def_ws)
        _newton_loop(lambda: self._step(rows), rows.unfinished, times)
        return _finish(rows.pts, rows.unfinished, valid)


def ray_constraint(deformed_pts, cam_origin, rays):
    """c = ray × (D(p) − cam): zero iff the deformed point lies on its ray."""
    return torch.cross(rays, deformed_pts - cam_origin, dim=-1)


def attach_implicit_surface(pts, sdf_fn, constraint_fn):
    """Reattach solved points (M, 3) to the parameters.

    sdf_fn (M, 3) → (M,) and constraint_fn (M, 3) → (M, 3) are closed over
    the parameters (garment SDF; translator, latents, poses, translation,
    camera) with their graphs. Returns TmpPs = p + M·(F − F.detach()) with
    M = −(BᵀB)⁻¹Bᵀ computed without a graph and zeroed where BᵀB is
    singular (|det| < 1e-4): its value is exactly p, its gradient with
    respect to θ is −g (BᵀB)⁻¹Bᵀ ∂F/∂θ, and p itself gets none."""
    with torch.enable_grad():
        q = pts.detach().requires_grad_(True)
        F = torch.cat([sdf_fn(q)[:, None], constraint_fn(q)], dim=-1)        # (M, 4)
        rows = [torch.autograd.grad(F[:, i].sum(), q, retain_graph=True)[0] for i in range(4)]
    B = torch.stack(rows, dim=1)                                               # (M, 4, 3)
    inv, ok = fast_3x3_inv(B.transpose(1, 2) @ B)
    Mt = torch.where(ok[:, None, None], -(inv @ B.transpose(1, 2)), 0.0)       # (M, 3, 4)
    return q.detach() + torch.einsum("mik,mk->mi", Mt, F - F.detach())
