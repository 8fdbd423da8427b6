"""The MLT step's large-step modes and the intermediate snapshots in the
port.

* bank_slots and the large-step kind against the JAX package for every
  combination of mala, h2mc, largestepmultiplexed and samplecache (H2MC
  with MALA and samplecache among them: the kind is 'cache' and the cache
  is attached, as in the JAX package); the kind is read off the JAX
  package's bank_slots (1 unless plain) and attach_cache (a path store
  only for cache-seeded steps);
* the parser gives the JAX package's Options for the three booleans;
* the port's MCMC against its own plain MC on lcbox for multiplexed large
  steps, cache-seeded ones (the cache pre-filled from the seed states, as
  the JAX package's cache test does, so the cache branch runs) and
  multiplexed ones with light-coordinate sampling: mean within 10% and
  row correlation above 0.9, as in test_torch_mcmc (120 iterations of 256
  chains);
* a CPU CLI render of the small generated box (maxdepth 4, cache-seeded
  large steps, light coordinates, reportintervalspp 1) writes
  intermediate.exr and .png, equal (rtol 1e-6) to direct + film / spp so
  far at the snapshot's step, rendered again with that many steps; its
  film is finite, non-negative and non-zero.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.integrators import mlt as jmlt
from langevin_mcmc_tpu.mcmc import chain as jchain
from langevin_mcmc_tpu.path.records import empty_record as jempty_record
from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu_torch import Options, testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.integrators.pathtrace import render_mc
from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.path.records import (empty_record, get_path_pss,
                                                  pss_dim)
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.utils.image_io import read_exr
from torch_parity import LCBOX, to_np

torch.set_num_threads(1)
D = 4
STEPS = 120     # chain iterations of the MC-vs-MCMC renders
FLAGS = ('mala', 'h2mc', 'large_step_multiplexed', 'sample_from_global_cache')


def _banked_jax(opts, C=4):
    z = jnp.zeros(C)
    st = jchain.init_chain_state(jempty_record((C,), D), jnp.zeros((C, 3)),
                                 jnp.zeros((C, 2)), z, z, z, opts)
    nb = jmlt.bank_slots(opts, D)
    return jmlt.BankedState(state=st, bank_screen=jnp.zeros((C, nb, 2)),
                            bank_contrib=jnp.zeros((C, nb, 3)))


def _banked_port(opts, C=4):
    z = torch.zeros(C)
    st = chain.init_chain_state(empty_record(C, D, 'cpu'), torch.zeros(C, 3),
                                torch.zeros(C, 2), z, z, z, opts)
    nb = mlt.bank_slots(opts, D)
    return mlt.BankedState(state=st, bank_screen=torch.zeros(C, nb, 2),
                           bank_contrib=torch.zeros(C, nb, 3))


@pytest.mark.parametrize('flags', list(itertools.product([False, True],
                                                         repeat=4)),
                         ids=lambda f: ''.join('1' if x else '0' for x in f))
def test_bank_slots_and_large_kind_match_jax(flags):
    opts = Options(max_depth=D, **dict(zip(FLAGS, flags)))
    assert mlt.bank_slots(opts, D) == jmlt.bank_slots(opts, D)
    jcache = jmlt.attach_cache(_banked_jax(opts), opts).cache
    tcache = mlt.attach_cache(_banked_port(opts), opts).cache
    assert (tcache is None) == (jcache is None)
    if jcache is not None:
        assert (tcache.rec is None) == (jcache.rec is None)
    want = ('cache' if jcache is not None and jcache.rec is not None
            else 'plain' if jmlt.bank_slots(opts, D) > 1 else 'mmlt')
    assert mlt.large_kind(opts) == want
    if opts.h2mc and opts.mala and opts.sample_from_global_cache:
        assert want == 'cache'
    # the chain state keeps a path snapshot exactly when the cache does
    st_t = _banked_port(opts).state
    assert (st_t.cached_rec is None) == \
        (_banked_jax(opts).state.cached_rec is None)


@pytest.mark.parametrize('flags', [(False, False, False), (True, False, False),
                                   (True, True, False), (True, True, True),
                                   (False, False, True)],
                         ids=['none', 'mmlt', 'cache', 'cache_lc', 'lc'])
def test_parser_options_match_jax(tmp_path, flags):
    xml = testscenes.write_scene(
        str(tmp_path), small=True, width=16, height=12, max_depth=D,
        large_step=('cache' if flags[1] else 'multiplexed' if flags[0]
                    else 'plain'), light_coords=flags[2])
    _, jo, _ = jax_parse(xml)
    _, to, _ = parse_scene(xml, device='cpu')
    for f in ('large_step_multiplexed', 'sample_from_global_cache',
              'use_light_coordinate_sampling', 'mala', 'h2mc'):
        assert getattr(to, f) == getattr(jo, f), f
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)


# ---------------------------------------------------------------------------
# MC against MCMC on lcbox
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def lcbox_mc():
    scene, opts, _ = parse_scene(LCBOX, film_wh=(32, 24), device='cpu')
    opts = opts.replace(max_depth=3, direct_spp=16, num_chains=256,
                        num_init_samples=4096, large_step_probability=0.3)
    with torch.no_grad():
        mc = to_np(render_mc(scene, opts.replace(spp=64),
                             torch.Generator().manual_seed(0), chunk=4096))
    return scene, opts, mc


def _render_prefilled(scene, opts, gen, num_steps):
    """render_mlt with the cache rows pre-filled from the seed states
    (records included) before the chain loop, so cache-seeded large steps
    run from the first iteration. Returns (film, stats)."""
    b, length_dist, banked = mlt.bootstrap(scene, opts, gen, chunk=4096)
    direct = mlt.render_direct(scene, opts, gen, chunk=4096)
    init = banked
    banked = mlt.attach_cache(banked, opts)
    st = banked.state
    C = opts.num_chains
    cache = banked.cache
    for _ in range(2):
        cache = cache_mod.push_batch(
            cache, pss_dim(st.rec), get_path_pss(st.rec, 2 * opts.max_depth),
            torch.zeros(C, 2 * opts.max_depth),
            torch.zeros(C, 2 * opts.max_depth), st.ls_score,
            torch.ones(C, dtype=torch.bool), opts, s_tag=st.rec.cam_depth,
            t_tag=st.rec.lgt_depth, rec=st.rec)
    assert (to_np(cache.count) >= opts.pss_max_size).any()
    banked = dataclasses.replace(banked, cache=cache)
    step = mlt.make_mlt_step(scene, opts, b, opts.large_step_probability,
                             length_dist=length_dist)
    film = torch.zeros((scene.height, scene.width, 3))
    for _ in range(num_steps):
        banked = step(gen, banked, film, init)
    npix = scene.width * scene.height
    return direct + film / (num_steps * C / npix), step.counts


@pytest.mark.parametrize('mode', ['multiplexed', 'cache', 'multiplexed_lc'])
def test_mcmc_matches_mc_mean(lcbox_mc, mode):
    scene, opts, mc = lcbox_mc
    opts = opts.replace(large_step_multiplexed=True,
                        sample_from_global_cache=mode == 'cache',
                        use_light_coordinate_sampling=mode.endswith('lc'))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if mode == 'cache':
            opts = opts.replace(pss_max_size=64)
            film, counts = _render_prefilled(scene, opts, gen, STEPS)
            assert int(counts['cache']) > 50 and \
                int(counts['cache_accepts']) > 0, counts
        else:
            film, _ = mlt.render_mlt(scene, opts, gen, num_steps=STEPS,
                                     chunk=4096)
    img = to_np(film)
    assert np.isfinite(img).all()
    m_mc, m_mlt = mc.mean(), img.mean()
    assert abs(m_mlt - m_mc) / m_mc < 0.10, f'MC {m_mc} vs MCMC {m_mlt}'
    corr = np.corrcoef(mc.mean((1, 2)), img.mean((1, 2)))[0, 1]
    assert corr > 0.9, f'row correlation {corr}'


# ---------------------------------------------------------------------------
# the CLI and the intermediate snapshots
# ---------------------------------------------------------------------------

def test_cli_writes_intermediate_snapshot(tmp_path):
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    xml = testscenes.write_scene(str(tmp_path / 'scene'), small=True,
                                 width=64, height=48, max_depth=4,
                                 num_chains=1024, num_init_samples=2048,
                                 large_step='cache', light_coords=True)
    with open(xml) as f:
        text = f.read()
    with open(xml, 'w') as f:
        f.write(text.replace('</dpt>', '    <integer name="reportintervalspp" '
                             'value="1"/>\n    </dpt>'))
    out = str(tmp_path / 'out')
    res = cli_main([xml, '--device', 'cpu', '--spp', '2', '--chunk', '2048',
                    '--output-dir', out])[0]
    film = res['film']
    assert np.isfinite(film).all() and film.min() >= 0.0 and film.mean() > 0
    assert res['timings']['steps'] == 6
    assert res['timings']['large'] > 0
    for ext in ('exr', 'png'):
        assert os.path.exists(os.path.join(out, f'intermediate.{ext}'))
    snap = read_exr(os.path.join(out, 'intermediate.exr'))

    # the snapshot at step 3 (1 spp: 64 * 48 / 1024 steps) is the render
    # that stops there
    scene, opts, _ = parse_scene(xml, device='cpu')
    assert opts.report_interval_spp == 1
    with torch.no_grad():
        want, _ = mlt.render_mlt(scene, opts.replace(spp=2),
                                 torch.Generator().manual_seed(
                                     opts.seed_offset),
                                 num_steps=3, chunk=2048)
    np.testing.assert_allclose(snap, to_np(want), rtol=1e-6, atol=1e-7)
