"""H2MC's proposal Gaussian, plain, for the benchmark's check of the
Gaussians an H2MC run stores (lmcbench/h2mc_check.py):

* gaussian(): the closed form of dpt's ComputeGaussian (h2mc.cpp:3-68)
  with its isotropic fallback (h2mc.cpp:85-92), lane by lane, in float64
  on the host, the eigendecomposition included;
* grad_hessian(): the gradient and Hessian of the reference's frozen
  log-luminance (path/replay.py's log_luminance_fn over its own
  replay_path) by torch.autograd.functional.hessian of small blocks of
  lanes, and not by the program's loop of one backward pass a Hessian
  row;
* scores(): a record's sampling score and validity, its replay at a zero
  offset;
* log_pdf(): a Gaussian's log-density in float64, for the MH ratio of
  mutation_h2mc.h (the proposal densities q(x | y) / q(y | x) times the
  scores' ratio).

Departures from dpt, each deliberate:

* float64 throughout the closed form and its eigendecomposition (LAPACK's
  syevd through torch.linalg.eigh on the host, where dpt calls Eigen's
  SelfAdjointEigenSolver): the reference is the exact answer the
  program's float32 one is held to.
* Hamiltonian time L = pi / 2 and the factors of dpt's H2MCParam
  (h2mc.h:9-23) as the repository's ports take them: sinh(L)^2 and
  (e^L + e^-L - 1) / 2 for positive curvature, sin(L)^2 and 1 - cos(L)
  for negative.
* The lanes batched: a Hessian that the eigensolver cannot decompose (on
  finite float64 input LAPACK always can) falls back to the isotropic
  Gaussian, as the program does, where dpt has no such case.
* The gradient and Hessian of a path whose sampling score is not above
  1e-15 are zeros (mutation_h2mc.h), and a lane whose gradient or
  Hessian is not finite gets zeros in both (mutation_h2mc.h:80-85), as in
  the program.

Sets TF32 off: the Hessian's products then run in the reference's own
precision on a card.
"""

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L_TIME = math.pi / 2.0
# lanes a functional.hessian call differentiates together: its one
# vectorised double backward computes BLOCK * 2D rows of BLOCK lanes each
BLOCK = 16


def factors(L=L_TIME):
    """H2MCParam's factors of Hamiltonian time L: (positive-curvature
    scale, offset; negative-curvature scale, offset)."""
    return (math.sinh(L) ** 2, 0.5 * (math.exp(L) + math.exp(-L) - 1.0),
            math.sin(L) ** 2, 1.0 - math.cos(L))


def _isotropic(dim, sigma):
    inv = 1.0 / (sigma * sigma)
    return (torch.zeros(dim, dtype=torch.float64),
            torch.eye(dim, dtype=torch.float64) * inv,
            dim * math.log(inv))


def gaussian_one(grad, hess, sigma, ss_score, L=L_TIME):
    """One lane's Gaussian (mean [d], inv_cov [d, d], log_det, fallback)
    in float64, from its gradient [d] and Hessian [d, d] of the
    log-luminance, following ComputeGaussian eigenvalue by eigenvalue."""
    g = grad.double().cpu()
    h = hess.double().cpu()
    dim = g.shape[0]
    inv_sigma_sq = 1.0 / (sigma * sigma)
    if not ss_score > 1e-15:
        g, h = torch.zeros_like(g), torch.zeros_like(h)
    # h2mc.cpp:85-92: a Hessian below 0.5 / sigma^2 (Frobenius) takes the
    # isotropic Gaussian
    if float(torch.linalg.norm(h)) < 0.5 * inv_sigma_sq \
            or not ss_score > 1e-15:
        return _isotropic(dim, sigma) + (True,)
    try:
        lam, vec = torch.linalg.eigh(h)
    except torch.linalg.LinAlgError:
        return _isotropic(dim, sigma) + (True,)
    pos_scale, pos_offset, neg_scale, neg_offset = factors(L)
    proj = (vec.T @ g).tolist()
    eig = torch.zeros(dim, dtype=torch.float64)
    off = torch.zeros(dim, dtype=torch.float64)
    for i, li in enumerate(lam.tolist()):
        e = 1.0 / abs(li) if abs(li) > 1e-10 else 0.0
        o_buf = e * proj[i]
        if abs(li) > 1e-10:
            s2, o = (pos_scale, pos_offset * o_buf) if li > 0.0 \
                else (neg_scale, neg_offset * o_buf)
        else:
            s2, o = L * L, 0.5 * o_buf * L * L
        e *= s2
        eig[i] = 1.0 / e if e > 1e-10 else 0.0
        off[i] = o
    post = eig + inv_sigma_sq
    inv_cov = vec @ torch.diag(post) @ vec.T
    mean = vec @ (eig / post * off)
    log_det = float(torch.log(post).sum())
    return mean, inv_cov, log_det, False


def gaussian(grad, hess, sigma, ss_score, L=L_TIME):
    """The Gaussians of n lanes: dict of mean [n, d], inv_cov [n, d, d],
    log_det [n] (float64, host) and fallback [n] bool."""
    out = [gaussian_one(grad[i], hess[i], sigma, float(ss_score[i]), L)
           for i in range(grad.shape[0])]
    return dict(mean=torch.stack([o[0] for o in out]),
                inv_cov=torch.stack([o[1] for o in out]),
                log_det=torch.tensor([o[2] for o in out],
                                     dtype=torch.float64),
                fallback=torch.tensor([o[3] for o in out]))


def grad_hessian(scene, opts, rec, block=BLOCK):
    """Gradient [n, 2D] and Hessian [n, 2D, 2D] of the frozen
    log-luminance of records rec (lmcref's PathRecord, on the scene's
    device, in its dtype) at a zero offset. Each block of lanes is one
    torch.autograd.functional.hessian (vectorised) of their summed
    log-luminance with respect to their offsets [b, 2D]: lanes are
    independent, so its diagonal blocks are the lanes' Hessians. A lane
    whose gradient or Hessian is not finite gets zeros in both."""
    from ..path.replay import log_luminance_fn
    from ..utils.tree import tree_map
    n = rec.time.shape[0]
    dm = 2 * rec.max_depth
    dt = rec.time.dtype
    gs, hs = [], []
    for i in range(0, n, block):
        sl = slice(i, min(i + block, n))
        r = tree_map(lambda x: x[sl], rec)
        b = r.time.shape[0]
        f = log_luminance_fn(scene, opts, r)
        x0 = torch.zeros((b, dm), dtype=dt, device=r.time.device)
        with torch.enable_grad():
            x = x0.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(f(x).sum(), x)
            hb = torch.autograd.functional.hessian(
                lambda y: f(y).sum(), x0, vectorize=True)
        lanes = torch.arange(b, device=hb.device)
        gs.append(g.detach())
        hs.append(hb[lanes, :, lanes, :])
    g, h = torch.cat(gs), torch.cat(hs)
    finite = (torch.isfinite(g).all(-1)
              & torch.isfinite(h).flatten(1).all(-1))
    g = torch.where(finite[:, None], g, torch.zeros_like(g))
    h = torch.where(finite[:, None, None], h, torch.zeros_like(h))
    return g, h, finite


def scores(scene, opts, rec):
    """ss_score [n] and valid [n] of records rec: the perturb replay at a
    zero offset and zero jitters, as check.Reference.paths replays."""
    from ..path.replay import replay_path
    n = rec.time.shape[0]
    D = rec.cam_tri.shape[1]
    dev, dt = rec.time.device, rec.time.dtype
    zero = lambda *s: torch.zeros((n,) + s, dtype=dt, device=dev)
    with torch.no_grad():
        _, res = replay_path(scene, opts, rec, zero(2 * D),
                             dict(time=zero(), cam_disc=zero(D),
                                  lgt_disc=zero(D)), mode='perturb')
    return res['ss_score'], res['valid']


def log_pdf(x, g):
    """log N(x; mean, inv_cov^-1) [n] in float64 of points x [n, d] under
    gaussian()'s Gaussians g: -d/2 log(2 pi) + log_det / 2 - (x - mean)^T
    inv_cov (x - mean) / 2."""
    d = x.double() - g['mean']
    quad = torch.einsum('ci,cij,cj->c', d, g['inv_cov'], d)
    return -0.5 * d.shape[-1] * math.log(2.0 * math.pi) \
        + 0.5 * g['log_det'] - 0.5 * quad
