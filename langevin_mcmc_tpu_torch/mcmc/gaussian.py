"""Proposal Gaussians: isotropic, MALA-diagonal and H2MC-dense, batched over
chains (port of mcmc/gaussian.py).

Every chain carries a max_dim-sized Gaussian; padded dims get identical
parameters on both sides of the Metropolis ratio, so their log-pdf terms
cancel exactly. The diagonal form (MALA) carries [C, 1, 1] placeholder
dense factors, which gaussian_log_pdf and gaussian_sample recognise by
shape; Gaussians that are mixed per lane must have the same form.
"""

import dataclasses

import numpy as np
import torch

from ..ops import tracing
from ..ops.graphs import eager_call


@dataclasses.dataclass
class Gaussian:
    """Batched proposal Gaussian: the diagonal form uses cov_l_d and
    inv_cov_d, the dense form cov_l and inv_cov; is_diagonal says which,
    per lane."""
    mean: torch.Tensor       # [C, dim]
    cov_l_d: torch.Tensor    # [C, dim] diagonal sqrt-covariance
    inv_cov_d: torch.Tensor  # [C, dim]
    cov_l: torch.Tensor      # [C, dim, dim] dense factor (or [C, 1, 1])
    inv_cov: torch.Tensor    # [C, dim, dim] (or [C, 1, 1])
    log_det: torch.Tensor    # [C] log|invCov|
    is_diagonal: torch.Tensor  # [C] bool


def isotropic_gaussian(C, dim, sigma, device, dense=False):
    """diag(sigma) around zero; dense=True also fills the dense factors
    (the H2MC form), else they are [C, 1, 1] placeholders."""
    if not isinstance(sigma, torch.Tensor):
        sigma = torch.full((), sigma, dtype=torch.float32, device=device)
    sigma = torch.broadcast_to(sigma, (C,))[:, None]
    inv_sq = 1.0 / torch.square(sigma)
    ddim = dim if dense else 1
    eye = torch.eye(ddim, device=device).expand(C, ddim, ddim)
    return Gaussian(mean=torch.zeros((C, dim), device=device),
                    cov_l_d=torch.broadcast_to(sigma, (C, dim)).clone(),
                    inv_cov_d=torch.broadcast_to(inv_sq, (C, dim)).clone(),
                    cov_l=eye * sigma[..., None],
                    inv_cov=eye * inv_sq[..., None],
                    log_det=torch.log(inv_sq[:, 0]) * dim,
                    is_diagonal=torch.full((C,), not dense, dtype=torch.bool,
                                           device=device))


def _is_placeholder(g, dim):
    return g.inv_cov.shape[-1] != dim


def gaussian_log_pdf(offset, g: Gaussian):
    d = offset - g.mean
    dim = offset.shape[-1]
    log_pdf = dim * (-0.9189385332046727) + 0.5 * g.log_det
    quad_diag = torch.sum(d * g.inv_cov_d * d, -1)
    if _is_placeholder(g, dim):
        return log_pdf - 0.5 * quad_diag
    quad_dense = torch.einsum('ci,cij,cj->c', d, g.inv_cov, d)
    return log_pdf - 0.5 * torch.where(g.is_diagonal, quad_diag, quad_dense)


def gaussian_sample(g: Gaussian, z):
    """x = covL z + mean for standard-normal draws z [C, dim]."""
    x_diag = g.cov_l_d * z + g.mean
    if _is_placeholder(g, z.shape[-1]):
        return x_diag
    x_dense = torch.einsum('cij,cj->ci', g.cov_l, z) + g.mean
    return torch.where(g.is_diagonal[:, None], x_diag, x_dense)


def mala_gaussian(v1, v2, ss, shk, M, sc, opts):
    """MALA preconditioned drift proposal.

    v1/v2: [C, dim] moment EMAs; ss: stepsize [C]; shk: shrink prior sigma;
    M: diagonal preconditioner [C, dim]; sc: current ssScore [C]
    (zero-score lanes fall back to isotropic shk)."""
    C, dim = v1.shape
    shrk = 1.0 / (shk * shk)
    cov_t = torch.square(ss)[:, None] * (M + 1.0)
    inv_cov = 1.0 / torch.clamp(cov_t, min=1e-12) + shrk
    cov = 1.0 / inv_cov
    mean = torch.clamp(v1, opts.mtm_min, opts.mtm_max) * cov / 2.0
    log_det = torch.sum(torch.log(inv_cov), -1)
    zero = (sc <= 1e-10)[:, None]
    inv_cov = torch.where(zero, torch.full_like(inv_cov, shrk), inv_cov)
    cov_l_d = torch.where(zero, torch.full_like(cov, shk), torch.sqrt(cov))
    mean = torch.where(zero, torch.zeros_like(mean), mean)
    log_shrk = torch.log(torch.full((), shrk, dtype=torch.float32,
                                    device=v1.device))
    log_det = torch.where(zero[:, 0], dim * log_shrk, log_det)
    eye = torch.ones((C, 1, 1), device=v1.device)
    return Gaussian(mean=mean, cov_l_d=cov_l_d, inv_cov_d=inv_cov,
                    cov_l=eye, inv_cov=eye, log_det=log_det,
                    is_diagonal=torch.ones(C, dtype=torch.bool,
                                           device=v1.device))


# lanes per batched eigendecomposition: cuSOLVER's batched syev refused a
# batch of 65,536 16x16 matrices (CUSOLVER_STATUS_INVALID_VALUE, H100,
# torch 2.11 / CUDA 12.8) and ran batches of 8,192
EIGH_LANES = 8192


def _eigh(hess):
    """torch.linalg.eigh in batches of EIGH_LANES. Its error check reads
    the solver's info flags on the host, so a captured chain step runs it
    between graphs (ops/graphs.eager_call). A lane whose
    eigendecomposition the solver cannot give gets NaN eigenvalues
    (_eigh_batch), which h2mc_gaussian takes as its isotropic fallback:
    no Hessian ends the render."""
    parts = [_eigh_batch(h) for h in torch.split(hess, EIGH_LANES)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _eigh_batch(hess):
    """torch.linalg.eigh of a batch [n, dim, dim]; where the solver
    raises (it names only the first lane it failed on), the batch is
    split in halves until each lane it fails on stands alone, and such a
    lane gets NaN eigenvalues and the identity's eigenvectors."""
    try:
        return torch.linalg.eigh(hess)
    except torch.linalg.LinAlgError:
        pass
    n, dim = hess.shape[0], hess.shape[-1]
    if n == 1:
        return (torch.full((1, dim), float('nan'), dtype=hess.dtype,
                           device=hess.device),
                torch.eye(dim, dtype=hess.dtype, device=hess.device)[None])
    lo, hi = _eigh_batch(hess[:n // 2]), _eigh_batch(hess[n // 2:])
    return torch.cat([lo[0], hi[0]]), torch.cat([lo[1], hi[1]])


def h2mc_gaussian(grad, hess, sigma, sc, L=np.pi / 2.0):
    """H2MC anisotropic Gaussian from the gradient [C, dim] and Hessian
    [C, dim, dim] of the log-luminance; sigma the isotropic prior, sc the
    ssScore [C]. Lanes with sc ~ 0 or ||H|| < 0.5 / sigma^2 fall back to
    the isotropic N(0, sigma^2), as do lanes whose eigendecomposition the
    solver could not give (_eigh). The eigendecomposition is a batched
    torch.linalg.eigh, EIGH_LANES lanes at a time. Traced as the span
    gauss.h2mc. Returns (the Gaussian, the fallback lanes [C] bool)."""
    with tracing.span('gauss.h2mc'):
        return _h2mc_gaussian(grad, hess, sigma, sc, L)


def _h2mc_gaussian(grad, hess, sigma, sc, L):
    C, dim = grad.shape
    pos_scale = 0.25 * (np.exp(L) - np.exp(-L)) ** 2
    pos_offset = 0.5 * (np.exp(L) + np.exp(-L) - 1.0)
    neg_scale = np.sin(L) ** 2
    neg_offset = -(np.cos(L) - 1.0)

    inv_sigma_sq = 1.0 / (sigma * sigma)
    eigval, eigvec = eager_call(_eigh, hess)
    abs_ev = torch.abs(eigval)
    nonzero = abs_ev > 1e-10
    eigen_buff = torch.where(nonzero, 1.0 / torch.clamp(abs_ev, min=1e-10),
                             torch.zeros_like(abs_ev))
    offset_buff = eigen_buff * torch.einsum('cji,cj->ci', eigvec, grad)
    pos = eigval > 0.0
    full = lambda a: torch.full_like(eigval, float(a))
    s2 = torch.where(nonzero, torch.where(pos, full(pos_scale),
                                          full(neg_scale)), full(L * L))
    o = torch.where(nonzero,
                    offset_buff * torch.where(pos, full(pos_offset),
                                              full(neg_offset)),
                    0.5 * offset_buff * L * L)
    eigen_buff = eigen_buff * s2
    eigen_buff = torch.where(eigen_buff > 1e-10,
                             1.0 / torch.clamp(eigen_buff, min=1e-12),
                             torch.zeros_like(eigen_buff))
    post = eigen_buff + inv_sigma_sq

    inv_cov = torch.einsum('cik,ck,cjk->cij', eigvec, post, eigvec)
    mean = torch.einsum('cik,ck->ci', eigvec, (eigen_buff / post) * o)
    cov_l = eigvec * torch.rsqrt(torch.clamp(post, min=1e-20))[:, None, :]
    log_det = torch.sum(torch.log(torch.clamp(post, min=1e-30)), -1)

    hess_norm = torch.sqrt(torch.sum(torch.square(hess), (-1, -2)))
    fallback = ((sc <= 1e-15) | (hess_norm < 0.5 * inv_sigma_sq)
                | ~torch.isfinite(eigval).all(-1))
    iso = isotropic_gaussian(C, dim, sigma, grad.device, dense=True)
    fb = fallback[:, None]
    fbm = fallback[:, None, None]
    return Gaussian(
        mean=torch.where(fb, iso.mean, mean),
        cov_l_d=iso.cov_l_d, inv_cov_d=iso.inv_cov_d,
        cov_l=torch.where(fbm, iso.cov_l, cov_l),
        inv_cov=torch.where(fbm, iso.inv_cov, inv_cov),
        log_det=torch.where(fallback, iso.log_det, log_det),
        is_diagonal=torch.zeros(C, dtype=torch.bool,
                                device=grad.device)), fallback
