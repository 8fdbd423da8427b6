"""The isotropic-only small step (an MCMC block with neither MALA nor
H2MC) in the port against the JAX package.

* small_step_iso from the same chain states, offset and perturb noise
  (drawn in the test from JAX's own key split, then fed to both
  packages): proposal scores and MH ratios rtol 2e-3 per lane, at most 1%
  of lanes beyond 10x, the accept-able lanes equal on 99% of lanes, on the
  small generated box and on its --motion form (every query brute force,
  the camera panning);
* the parser gives the iso kind (mala and h2mc off) as JAX's does, and the
  chain step takes it: no cache, no Gaussian;
* the port's iso render_mlt against its own render_mc on lcbox: mean
  within 10% and row correlation above 0.9 (as test_torch_mcmc does for
  MALA).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.mcmc import chain as jchain
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.path import trace
from langevin_mcmc_tpu_torch.path.records import to_subpath
from langevin_mcmc_tpu_torch.scene.parse import parse_scene, parse_scene_host
from torch_parity import LCBOX, port_scene, to_np, assert_close_most

torch.set_num_threads(1)
C = 128
D = 3


@pytest.fixture(scope='module', params=['static', 'motion'])
def chains(request, tmp_path_factory):
    """A JAX and a port ChainState over the same seed paths (one technique
    per lane, picked by contribution), half of the lanes valid."""
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('iso')),
                                 small=True, width=64, height=48,
                                 max_depth=D, kernel='iso',
                                 motion=request.param == 'motion')
    js, jo, _ = jax_parse(xml)
    assert not (jo.mala or jo.h2mc)
    assert js.has_motion == (request.param == 'motion')
    jo = jo.replace(max_depth=D, num_chains=C)
    ts = port_scene(js)
    u = np.random.default_rng(61).random((C, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=3,
            max_depth=D)
    flat, s_tags, t_tags = con.flatten()
    ls = to_np(flat['ls_score'])
    pick = np.argmax(ls, 1)
    lanes = np.arange(C)
    take = lambda a: to_np(a)[lanes, pick]
    seeds = [take(flat['contrib']), take(flat['screen_pos']),
             take(flat['ls_score']), take(flat['ss_score']), ls.sum(1)]
    trec = to_subpath(rec, torch.as_tensor(s_tags[pick]),
                      torch.as_tensor(t_tags[pick]))
    jrec = JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(trec).items()})
    valid = lanes % 2 == 0
    jst = jchain.init_chain_state(jrec, *(jnp.asarray(x) for x in seeds),
                                  jo)
    jst = dataclasses.replace(jst, valid=jnp.asarray(valid))
    tst = chain.init_chain_state(trec, *(torch.as_tensor(x) for x in seeds),
                                 jo)
    tst = dataclasses.replace(tst, valid=torch.as_tensor(valid))
    return js, jo, ts, jst, tst


def test_iso_mh_ratio_matches_jax(chains):
    js, jo, ts, jst, tst = chains
    key = jax.random.PRNGKey(13)
    jprop, ja = jax.jit(lambda k, s: jchain.small_step_iso(js, jo, k, s))(
        key, jst)
    # small_step_iso's own draws: the offset from k_off, the noise from
    # k_noise as _perturb_noise splits it
    k_off, k_noise = jax.random.split(key)
    offset = np.array(jax.random.normal(k_off, (C, 2 * D))
                      * jo.perturb_std_dev)
    k1, k2, k3 = jax.random.split(k_noise, 3)
    sd = jo.discrete_std_dev
    noise = dict(time=jax.random.normal(k1, (C,)) * sd,
                 cam_disc=jax.random.normal(k2, (C, D)) * sd,
                 lgt_disc=jax.random.normal(k3, (C, D)) * sd)
    with torch.no_grad():
        tprop, ta = chain.small_step_iso(
            ts, jo, tst, torch.as_tensor(offset),
            {k: torch.as_tensor(np.array(v)) for k, v in noise.items()})
    ja = np.asarray(ja)
    assert (ja > 0).sum() >= C // 10 and (ja < 1).sum() >= 3
    assert (to_np(tprop['ok']) != np.asarray(jprop['ok'])).sum() <= C // 100
    for k in ('ls', 'ss', 'contrib', 'screen'):
        assert_close_most(to_np(tprop[k]), np.asarray(jprop[k]), 2e-3,
                          err_msg=f'proposal {k}')
    assert_close_most(to_np(ta), ja, 2e-3, err_msg='MH ratio')
    np.testing.assert_array_equal(to_np(tprop['rec'].cam_depth),
                                  np.asarray(jprop['rec'].cam_depth))


def test_parser_and_step_take_the_iso_kind(tmp_path):
    xml = testscenes.write_scene(str(tmp_path), small=True, width=16,
                                 height=12, max_depth=D, kernel='iso',
                                 num_chains=64, num_init_samples=512)
    _, jo, _ = jax_parse(xml)
    host, opts, _ = parse_scene_host(xml)
    assert dataclasses.asdict(opts) == dataclasses.asdict(jo)
    assert mlt.small_kind(opts) == 'iso'
    scene, opts, _ = parse_scene(xml, device='cpu')
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        b, length_dist, banked = mlt.bootstrap(scene, opts, gen, chunk=512)
        init = banked
        banked = mlt.attach_cache(banked, opts)
        assert banked.cache is None
        step = mlt.make_mlt_step(scene, opts, b, 0.3,
                                 length_dist=length_dist)
        film = torch.zeros((scene.height, scene.width, 3))
        st = dataclasses.replace(banked.state, gaussian_init=torch.ones(
            opts.num_chains, dtype=torch.bool))
        banked = step(gen, dataclasses.replace(banked, state=st), film, init)
    new = banked.state
    moved = ~torch.equal(new.ls_score, st.ls_score)
    assert moved and torch.isfinite(film).all() and film.min() >= 0
    # an accept clears gaussianInitialized; the Gaussian stays as it was
    acc = new.ls_score != st.ls_score
    assert not new.gaussian_init[acc].any()
    assert torch.equal(new.gaussian.mean, st.gaussian.mean)


def test_iso_mcmc_matches_mc_mean():
    from langevin_mcmc_tpu_torch.integrators.pathtrace import render_mc
    scene, opts, _ = parse_scene(LCBOX, film_wh=(32, 24), device='cpu')
    opts = opts.replace(max_depth=3, direct_spp=16, num_chains=256,
                        num_init_samples=4096, large_step_probability=0.3,
                        mala=False, h2mc=False)
    with torch.no_grad():
        mc = to_np(render_mc(scene, opts.replace(spp=64),
                             torch.Generator().manual_seed(0), chunk=4096))
        film, _ = mlt.render_mlt(scene, opts,
                                 torch.Generator().manual_seed(1),
                                 num_steps=240, chunk=4096)
    img = to_np(film)
    assert np.isfinite(img).all()
    m_mc, m_mlt = mc.mean(), img.mean()
    assert abs(m_mlt - m_mc) / m_mc < 0.10, f'MC {m_mc} vs MCMC {m_mlt}'
    corr = np.corrcoef(mc.mean((1, 2)), img.mean((1, 2)))[0, 1]
    assert corr > 0.9, f'row correlation {corr}'
