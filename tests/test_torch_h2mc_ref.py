"""H2MC in the port against the benchmark's plain reference
(benchmark/lmcref/mcmc/h2mc.py, which imports nothing of the port), on
the CPU at a small size (no JAX):

* path_grad_hessian (one backward pass a Hessian row, reading a bake)
  against the reference's Hessian by torch.autograd.functional.hessian of
  blocks of lanes: both are float32 autodiff of the same frozen replay, in
  other orders of accumulation, so within 1e-4 of the lane's largest
  entry;
* h2mc_gaussian (float32, batched cuSOLVER / LAPACK eigh) against the
  reference's float64 closed form, lane by lane, on planted gradients and
  Hessians: positive, negative and mixed curvature, near-zero eigenvalues
  and fallback lanes (zero score, a Hessian below 0.5 / sigma^2), each
  within the tolerances of the benchmark's Gaussian check
  (lmcbench/h2mc_check.py: inv_cov 1e-3 relative, the mean 1e-2 standard
  deviations, log_det 1e-2), which float32 meets on well-separated
  eigenvalues with margin;
* a lane whose eigendecomposition the solver refuses falls back to the
  isotropic Gaussian, the other lanes keep their Gaussians bit for bit,
  and a Hessian of NaNs ends nothing;
* a few H2MC steps of make_mlt_step: the Gaussians the chains store pass
  judge_gauss against the reference (gauss_mismatch 0), and the control,
  the reference computing in bfloat16, fails it;
* one more H2MC step of those chains (take_mh): the program's acceptance
  probabilities pass judge_mh against the reference's MH ratio
  (mh_mismatch 0), and those of a step whose ratio leaves out the
  proposal densities fail it.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'benchmark')
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from lmcbench import check, h2mc_check, scenegen  # noqa: E402
from lmcref.mcmc import h2mc as ref_h2mc  # noqa: E402
from lmcref.path.records import PathRecord as RefRecord  # noqa: E402

from langevin_mcmc_tpu_torch.integrators import mlt  # noqa: E402
from langevin_mcmc_tpu_torch.mcmc import chain  # noqa: E402
from langevin_mcmc_tpu_torch.mcmc import gaussian as G  # noqa: E402
from langevin_mcmc_tpu_torch.path import replay  # noqa: E402
from langevin_mcmc_tpu_torch.scene.parse import parse_scene  # noqa: E402
from langevin_mcmc_tpu_torch.utils.tree import tree_take  # noqa: E402

SIGMA = 0.01


@pytest.fixture(scope='module')
def h2mc_run(tmp_path_factory):
    """The small box with H2MC (max depth 3, 256 chains) after four
    steps of make_mlt_step from its bootstrap: (xml, scene, opts,
    banked)."""
    torch.set_num_threads(2)
    xml = scenegen.write_scene(str(tmp_path_factory.mktemp('h2mc')),
                               small=True, width=32, height=24, max_depth=3,
                               num_init_samples=1024, kernel='h2mc',
                               num_chains=256)
    scene, opts, _ = parse_scene(xml, device='cpu')
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        b, ld, banked = mlt.bootstrap(scene, opts, gen, chunk=512)
        init = banked
        banked = mlt.attach_cache(banked, opts)
        step = mlt.make_mlt_step(scene, opts, b, opts.large_step_probability,
                                 length_dist=ld)
        film = torch.zeros((scene.height, scene.width, 3))
        for _ in range(4):
            banked = step(gen, banked, film, init)
    return xml, scene, opts, banked


@pytest.fixture(scope='module')
def gauss_sample(h2mc_run):
    xml, _, opts, banked = h2mc_run
    sample = h2mc_check.take_gauss(7, banked, opts, n=256)
    return xml, sample, h2mc_check.reference_gauss(sample, xml)


def test_hessian_matches_reference(h2mc_run):
    xml, scene, opts, banked = h2mc_run
    st = banked.state
    idx = torch.nonzero(st.valid)[:48, 0]
    rec = tree_take(st.rec, idx)
    g, h, finite = replay.path_grad_hessian(
        scene, opts, rec, bake=chain._bake(scene, opts, rec))
    ref = check.Reference(xml, 'cpu')
    fields = check._rec_dict(st.rec, idx)
    rrec = check._ref_record(RefRecord, fields, slice(0, len(idx)), 'cpu',
                             torch.float32)
    g_r, h_r, finite_r = ref_h2mc.grad_hessian(ref.scene, ref.opts, rrec)
    assert torch.equal(finite, finite_r)
    scale = lambda a: a.abs().flatten(1).amax(1).clamp(min=1e-30)
    assert ((g - g_r).abs().flatten(1).amax(1) <= 1e-4 * scale(g_r)).all()
    assert ((h - h_r).abs().flatten(1).amax(1) <= 1e-4 * scale(h_r)).all()
    # not all trivial: some lanes have a Hessian past the fallback norm
    assert (h_r.flatten(1).norm(dim=1) > 0.5 / SIGMA ** 2).any()


def _planted(rng, C, dim):
    """Gradients and symmetric Hessians Q diag(lam) Q^T: lanes 0-1 zero
    score, 2-3 a Hessian below 0.5 / sigma^2, 4-7 all curvature
    negative, 8-11 all positive, 12-15 with the last two dimensions
    unused (zero rows, columns and gradient, as a path shorter than the
    maximum depth has: the near-zero branch), the rest mixed; eigenvalues
    log-spaced and well separated."""
    grad = rng.normal(size=(C, dim)) * 30.0
    hess = np.zeros((C, dim, dim))
    for c in range(C):
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        lam = np.logspace(1, 4.5, dim) * rng.choice([-1.0, 1.0], dim)
        if 4 <= c < 8:
            lam = -np.abs(lam)
        elif 8 <= c < 12:
            lam = np.abs(lam)
        hess[c] = (q * lam) @ q.T
        if 12 <= c < 16:
            hess[c, -2:], hess[c, :, -2:], grad[c, -2:] = 0.0, 0.0, 0.0
    hess[2:4] *= 1e-4
    sc = np.ones(C)
    sc[0:2] = 0.0
    return (torch.as_tensor(grad, dtype=torch.float32),
            torch.as_tensor(hess, dtype=torch.float32),
            torch.as_tensor(sc, dtype=torch.float32))


def _judge(gauss, want):
    """Each lane's gaps, as h2mc_check judges them."""
    a = want['inv_cov']
    inv_gap = (gauss.inv_cov.double() - a).flatten(1).norm(dim=1) \
        / a.flatten(1).norm(dim=1)
    dm = gauss.mean.double() - want['mean']
    mean_gap = torch.einsum('ci,cij,cj->c', dm, a, dm).clamp(min=0).sqrt()
    ld_gap = (gauss.log_det.double() - want['log_det']).abs()
    return inv_gap, mean_gap, ld_gap


@pytest.mark.parametrize('dim', [6, 16])
def test_h2mc_gaussian_matches_float64_closed_form(dim):
    grad, hess, sc = _planted(np.random.default_rng(dim), 40, dim)
    gauss, fallback = G.h2mc_gaussian(grad, hess, SIGMA, sc)
    want = ref_h2mc.gaussian(grad, hess, SIGMA, sc)
    assert fallback.tolist() == want['fallback'].tolist()
    assert fallback[:4].all() and not fallback[4:].any()
    inv_gap, mean_gap, ld_gap = _judge(gauss, want)
    assert inv_gap.max() <= h2mc_check.INV_COV_RTOL, inv_gap
    assert mean_gap.max() <= h2mc_check.MEAN_TOL, mean_gap
    assert ld_gap.max() <= h2mc_check.LOG_DET_TOL, ld_gap
    # the negative-curvature lanes take neg_scale: post = |lambda| /
    # sin(L)^2 + 1 / sigma^2, so inv_cov is not the isotropic prior's
    assert (gauss.inv_cov[4:8].diagonal(dim1=1, dim2=2)
            > 1.0 / SIGMA ** 2 + 1.0).any()


def test_eigh_failure_falls_back_per_lane(monkeypatch):
    grad, hess, sc = _planted(np.random.default_rng(3), 40, 6)
    want, _ = G.h2mc_gaussian(grad, hess, SIGMA, sc)
    bad = [5, 17, 18]
    hess_bad = hess.clone()
    hess_bad[bad, 0, 0] += 12345.0
    planted = hess_bad[bad, 0, 0].clone()
    eigh = torch.linalg.eigh

    def refusing(h, *a, **k):
        if torch.isin(h[:, 0, 0], planted).any():
            raise torch.linalg.LinAlgError('planted failure')
        return eigh(h, *a, **k)
    monkeypatch.setattr(torch.linalg, 'eigh', refusing)
    got, fallback = G.h2mc_gaussian(grad, hess_bad, SIGMA, sc)
    keep = torch.ones(40, dtype=torch.bool)
    keep[bad] = False
    assert fallback[bad].all()
    iso = G.isotropic_gaussian(40, 6, SIGMA, 'cpu', dense=True)
    for k in ('mean', 'inv_cov', 'cov_l', 'log_det'):
        assert torch.equal(getattr(got, k)[bad], getattr(iso, k)[bad])
        assert torch.equal(getattr(got, k)[keep], getattr(want, k)[keep])
    # a Hessian of NaNs (the solver refuses it or returns NaNs) falls back
    monkeypatch.setattr(torch.linalg, 'eigh', eigh)
    hess_nan = hess.clone()
    hess_nan[9] = float('nan')
    got, fallback = G.h2mc_gaussian(grad, hess_nan, SIGMA, sc)
    assert fallback[9] and torch.isfinite(got.inv_cov).all()


def test_stored_gaussians_pass_the_gaussian_check(gauss_sample):
    _, sample, want = gauss_sample
    assert sample['eligible'] > 0 and sample['ss'].shape[0] > 0
    num, info = h2mc_check.judge_gauss(sample, want)
    assert num['gauss_mismatch'] == 0.0, info
    # the sample holds Gaussians that are not the isotropic fallback
    assert info['gauss_fallback'] < 1.0, info


def test_bf16_control_fails_the_gaussian_check(gauss_sample):
    xml, sample, want = gauss_sample
    low = h2mc_check.reference_gauss(sample, xml, torch.bfloat16)
    num, info = h2mc_check.judge_gauss(sample, want, gauss=low)
    assert num['gauss_mismatch'] > h2mc_check.GAUSS_LIMIT, info


@pytest.fixture(scope='module')
def mh_sample(h2mc_run, gauss_sample):
    xml, scene, opts, banked = h2mc_run
    _, sample, want = gauss_sample
    mh = h2mc_check.take_mh(7, sample, banked, scene, opts)
    return mh, h2mc_check.reference_mh(sample, mh, want, xml)


def test_mh_ratio_matches_the_reference(mh_sample):
    mh, a_ref = mh_sample
    num, info = h2mc_check.judge_mh(mh, a_ref)
    assert num['mh_mismatch'] == 0.0, info
    # the step proposed valid paths, and rejected some of them
    assert info['mh_valid'] > 0.5 and 0.0 < info['mh_accept_ref'] < 1.0, \
        info


def test_mh_check_fails_a_ratio_without_the_densities(h2mc_run, gauss_sample,
                                                      mh_sample, monkeypatch):
    xml, scene, opts, banked = h2mc_run
    _, sample, _ = gauss_sample
    _, a_ref = mh_sample
    monkeypatch.setattr(G, 'gaussian_log_pdf',
                        lambda offset, g: torch.zeros(offset.shape[:-1]))
    mh = h2mc_check.take_mh(7, sample, banked, scene, opts)
    num, info = h2mc_check.judge_mh(mh, a_ref)
    assert num['mh_mismatch'] > h2mc_check.MH_LIMIT, info
