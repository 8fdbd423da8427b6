"""The rough dielectric BSDF (Beckmann microfacet) in the port against the
JAX package, and the JAX BSDF tests of it run on the port.

* evaluate and sample of all three BSDFs, dispatched per lane, on the same
  random directions, randoms and materials (both sides of the surface,
  twosided or not), with adjoint both ways: values equal JAX's within
  rtol 1e-4 (atol 1e-6) on every lane but a bounded few: a direction
  within f32 rounding of a cut-off (|cos| = 1e-4, total internal
  reflection, the reflect/refract pick u_disc <= F) can take the other
  branch (assert_close_most, at most 1% of lanes);
* the Beckmann pieces and the Fresnel term equal JAX's within rtol 1e-5,
  atol 1e-5 (the sampled micronormal's sqrt(1 - cos^2) cancels near the
  pole: the two libraries' f32 log and sqrt leave ~3e-6 there);
* ports of test_sample_eval_consistency_roughdielectric and
  test_fresnel_total_internal_reflection (tests/test_bsdf.py), with the
  tolerances stated there;
* gradients of sample through the dielectric are finite.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.ops import bsdf as jbsdf
from langevin_mcmc_tpu_torch.ops import bsdf
from langevin_mcmc_tpu_torch.scene.scenedata import (BSDF_LAMBERTIAN,
                                                      BSDF_PHONG,
                                                      BSDF_ROUGH_DIELECTRIC)
from torch_parity import to_np, assert_close_most

torch.set_num_threads(1)
N = 4096
RTOL = 1e-4


def _dirs(rng, n, up=False):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if up:
        d[:, 2] = np.abs(d[:, 2]) + 0.05
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


def _params(rng, n, mat_type=None):
    """Per-lane material parameters as numpy arrays (MatParams fields)."""
    eta = rng.uniform(1.2, 1.8, n).astype(np.float32)
    return dict(
        mat_type=(rng.integers(0, 3, n) if mat_type is None
                  else np.full(n, mat_type)).astype(np.int32),
        twosided=rng.random(n) < 0.5,
        kd=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        ks=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        exponent=rng.uniform(5, 80, n).astype(np.float32),
        ks_weight=rng.uniform(0, 1, n).astype(np.float32),
        eta=eta, inv_eta=(1.0 / eta).astype(np.float32),
        alpha=rng.uniform(0.05, 0.5, n).astype(np.float32))


def _both(p):
    return (bsdf.MatParams(**{k: torch.as_tensor(v) for k, v in p.items()}),
            jbsdf.MatParams(**{k: jnp.asarray(v) for k, v in p.items()}))


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(21)
    n = _dirs(rng, N)
    return dict(p=_params(rng, N), wi=_dirs(rng, N), wo=_dirs(rng, N),
                n=n, u=rng.random((N, 2)).astype(np.float32),
                ud=rng.random(N).astype(np.float32))


@pytest.mark.parametrize('adjoint', [False, True])
def test_evaluate_matches_jax(inputs, adjoint):
    tm, jm = _both(inputs['p'])
    t = lambda k: torch.as_tensor(inputs[k])
    j = lambda k: jnp.asarray(inputs[k])
    got = bsdf.evaluate(tm, t('wi'), t('n'), t('wo'), adjoint)
    want = jbsdf.evaluate(jm, j('wi'), j('n'), j('wo'), adjoint)
    assert (to_np(got[0]).max(1) > 0).sum() > N // 4
    for k, name in enumerate(('contrib', 'cos_wo', 'pdf', 'rev_pdf')):
        assert_close_most(to_np(got[k]), np.asarray(want[k]), RTOL,
                          atol=1e-6, err_msg=f'evaluate {name}')


@pytest.mark.parametrize('adjoint', [False, True])
def test_sample_matches_jax(inputs, adjoint):
    tm, jm = _both(inputs['p'])
    t = lambda k: torch.as_tensor(inputs[k])
    j = lambda k: jnp.asarray(inputs[k])
    got = bsdf.sample(tm, t('wi'), t('n'), t('u'), t('ud'), adjoint)
    want = jbsdf.sample(jm, j('wi'), j('n'), j('u'), j('ud'), adjoint)
    valid = to_np(got[5])
    assert (valid != np.asarray(want[5])).sum() <= N // 100
    rough = inputs['p']['mat_type'] == BSDF_ROUGH_DIELECTRIC
    assert valid[rough].mean() > 0.5
    both = valid & np.asarray(want[5])
    for k, name in enumerate(('wo', 'contrib', 'cos_wo', 'pdf', 'rev_pdf')):
        assert_close_most(to_np(got[k])[both], np.asarray(want[k])[both],
                          RTOL, atol=1e-6, err_msg=f'sample {name}')


def test_microfacet_pieces_match_jax():
    rng = np.random.default_rng(5)
    h = _dirs(rng, N, up=True)
    alpha = rng.uniform(0.05, 0.5, N).astype(np.float32)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(1.2, 1.8, N).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    t, j = torch.as_tensor, jnp.asarray
    pairs = [
        (bsdf.beckmann_d(t(h), t(alpha)), jbsdf.beckmann_d(j(h), j(alpha))),
        (bsdf.beckmann_g1(t(alpha), t(cos)),
         jbsdf.beckmann_g1(j(alpha), j(cos))),
        (bsdf.beckmann_g(t(alpha), t(cos), t(cos[::-1].copy())),
         jbsdf.beckmann_g(j(alpha), j(cos), j(cos[::-1].copy()))),
        (bsdf.fresnel_dielectric_ext(t(cos), t(eta), t(1 / eta))[0],
         jbsdf.fresnel_dielectric_ext(j(cos), j(eta), j(1 / eta))[0]),
        (bsdf.fresnel_dielectric_ext(t(cos), t(eta), t(1 / eta))[1],
         jbsdf.fresnel_dielectric_ext(j(cos), j(eta), j(1 / eta))[1]),
        (bsdf.sample_micronormal(t(u), t(alpha))[0],
         jbsdf.sample_micronormal(j(u), j(alpha))[0]),
        (bsdf.sample_micronormal(t(u), t(alpha))[1],
         jbsdf.sample_micronormal(j(u), j(alpha))[1])]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f'pair {k}')


def test_roughness_reports_alpha():
    rng = np.random.default_rng(6)
    p = _params(rng, 64)
    tm, _ = _both(p)
    want = np.where(p['mat_type'] == BSDF_ROUGH_DIELECTRIC, p['alpha'], 1.0)
    np.testing.assert_array_equal(to_np(bsdf.roughness(tm)), want)


def _fixed(n, mat_type):
    """The material of tests/test_bsdf.py make_mp, on n lanes."""
    return bsdf.MatParams(
        mat_type=torch.full((n,), mat_type, dtype=torch.int32),
        twosided=torch.zeros(n, dtype=torch.bool),
        kd=torch.ones(n, 3), ks=torch.ones(n, 3),
        exponent=torch.full((n,), 50.0), ks_weight=torch.full((n,), 0.35),
        eta=torch.full((n,), 1.5), inv_eta=torch.full((n,), 1.0 / 1.5),
        alpha=torch.full((n,), 0.1))


def test_sample_eval_consistency_roughdielectric():
    n = 4096
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.random((n, 2), np.float32))
    ud = torch.as_tensor(rng.random((n,), np.float32))
    mp = _fixed(n, BSDF_ROUGH_DIELECTRIC)
    d = np.random.default_rng(4).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wi = torch.as_tensor(d.astype(np.float32))
    normal = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    wo, contrib_s, _, pdf_s, _, valid = bsdf.sample(mp, wi, normal, u, ud)
    contrib_e, _, pdf_e, _ = bsdf.evaluate(mp, wi, normal, wo)
    v = to_np(valid)
    lhs = to_np(contrib_s)[v] * to_np(pdf_s)[v][:, None]
    rhs = to_np(contrib_e)[v]
    keep = np.abs(rhs).max(1) > 1e-7
    assert v.mean() > 0.5
    np.testing.assert_allclose(lhs[keep], rhs[keep], rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(to_np(pdf_s)[v], to_np(pdf_e)[v], rtol=5e-2,
                               atol=1e-4)


def test_fresnel_total_internal_reflection():
    f, cos_t = bsdf.fresnel_dielectric_ext(torch.tensor(-0.1),
                                           torch.tensor(1.5),
                                           torch.tensor(1.0 / 1.5))
    assert float(f) == 1.0 and float(cos_t) == 0.0
    f2, cos_t2 = bsdf.fresnel_dielectric_ext(torch.tensor(1.0),
                                             torch.tensor(1.5),
                                             torch.tensor(1.0 / 1.5))
    # normal incidence: ((n-1)/(n+1))^2 = 0.04
    assert abs(float(f2) - 0.04) < 1e-3
    assert float(cos_t2) < 0  # entering


@pytest.mark.parametrize('u_disc', [0.01, 0.9])
def test_dielectric_sample_differentiable(u_disc):
    """Reflection (u_disc below F) and refraction: finite gradients."""
    mp = _fixed(1, BSDF_ROUGH_DIELECTRIC)
    wi = torch.tensor([[0.3, 0.2, 0.93]])
    wi = wi / wi.norm()
    normal = torch.tensor([[0.0, 0.0, 1.0]])
    u = torch.tensor([[0.4, 0.6]], requires_grad=True)
    _, contrib, _, _, _, valid = bsdf.sample(mp, wi, normal, u,
                                             torch.tensor([u_disc]))
    assert bool(valid[0])
    (g,) = torch.autograd.grad(contrib.sum(), u)
    assert torch.isfinite(g).all()


def test_lambertian_phong_unchanged_by_dispatch():
    """Lanes of the two older BSDFs give the same values through the
    three-way dispatch as through their own branch functions."""
    rng = np.random.default_rng(9)
    n = 512
    for mt, fn in ((BSDF_LAMBERTIAN, bsdf._eval_lambertian),
                   (BSDF_PHONG, bsdf._eval_phong)):
        p = _params(rng, n, mt)
        tm, _ = _both(p)
        wi, wo, nn = (torch.as_tensor(_dirs(rng, n)) for _ in range(3))
        got = bsdf.evaluate(tm, wi, nn, wo)
        want = fn(tm, wi, nn, wo)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
