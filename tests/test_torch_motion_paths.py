"""Paths on a moving scene (the small generated open scene with --motion,
D = 3: the torus and the quad light turn and move between the keyframes,
the camera pans, the env map turns) in the port against the JAX package,
from the same uniform tape, offsets and noise. Every ray query of both
packages is brute force at the lane's time, and no replay takes a bake.

* bidirectional generation, and generate_subpath with light-coordinate
  sampling on its slots: contributions rtol 2e-3 per lane, at most 1% of
  lanes beyond 10x (a lane on a discrete threshold: a BSDF lobe, Russian
  roulette, a triangle edge, an env CDF bin); triangle and light records
  equal on 99% of lanes;
* perturb replay and frozen replay of the generated paths with a PSS
  offset and perturb noise: rtol 2e-3 per lane, as above;
* path_grad and path_grad_hessian without a bake: the gradients rtol
  2e-2 (atol 4e-4) per lane, at most 1% of lanes beyond; each Hessian
  column against central differences of JAX's path_grad (see the test);
  the port's derivatives are finite;
* a bake is refused on a moving scene; the MALA step's derivative paths
  (the proposal-side gradient, the sparse current-side gradient) run
  without one.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.path import trace as jtrace
from langevin_mcmc_tpu.path import replay as jreplay
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.path import trace, replay
from langevin_mcmc_tpu_torch.path.records import to_subpath
from torch_parity import port_scene, jax_tree_to_numpy, to_np, \
    assert_close_most

torch.set_num_threads(1)
B = 256
D = 3
RTOL = 2e-3
SLOTS = [(2, 0), (3, 0), (4, 0), (2, 1), (2, 2), (1, 2)]
SUB_SLOTS = [(3, 0), (4, 0), (2, 1), (2, 2), (1, 3)]
KEYS = ('ls_score', 'ss_score', 'contrib', 'screen_pos', 'mis_weight')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('motion')),
                                 small=True, width=64, height=48,
                                 max_depth=D, scene='open', motion=True)
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D)
    assert js.has_motion
    ts = port_scene(js)
    u = np.random.default_rng(51).random((B, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=D)
    rng = np.random.default_rng(52)
    offset = (rng.normal(size=(B, 2 * D)) * 0.01).astype(np.float32)
    noise = {k: (rng.normal(size=s) * 0.01).astype(np.float32)
             for k, s in (('time', (B,)), ('cam_disc', (B, D)),
                          ('lgt_disc', (B, D)))}
    return js, jo, ts, u, rec, con, offset, noise


def _jax_rec(rec):
    return JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(rec).items()})


def _tag(rec, s, t):
    return to_subpath(rec, torch.full((B,), s, dtype=torch.int32),
                      torch.full((B,), t, dtype=torch.int32))


def _gen_ss(con, s, t):
    if s == 1:
        return to_np(con.l_ss_score[:, t - 2])
    return to_np(con.ss_score[:, s - 2, t])


def test_bidir_matches_jax(setup):
    js, jo, _, u, trec, tcon, _, _ = setup
    jrec, jcon, _, _ = jax.jit(lambda u: jtrace.generate_path_bidir(
        js, jo, jtrace.Tape(u, D), min_depth=-1, max_depth=D))(
            jnp.asarray(u))
    jf, tf = jcon.flatten()[0], tcon.flatten()[0]
    assert (np.asarray(jf['ls_score']) > 0).any(0).sum() >= 6
    for k in KEYS:
        assert_close_most(to_np(tf[k]), np.asarray(jf[k]), RTOL,
                          err_msg=f'bidir {k}')
    jr = jax_tree_to_numpy(jrec)
    same = np.ones(B, bool)
    for k in ('cam_tri', 'lgt_tri', 'cam_nee_light', 'cam_nee_lprim',
              'lgt_light_id', 'lgt_lprim', 'env_lprim'):
        same &= (to_np(getattr(trec, k)) == jr[k]).reshape(B, -1).all(1)
    assert (~same).sum() <= B // 100, f'{(~same).sum()} lanes differ'
    # the moving torus and light, and the turning sky, are on these paths
    torus = 2 * np.prod(testscenes.SMALL_TORUS_SEGMENTS)
    cam_tri = jr['cam_tri']
    assert ((cam_tri >= 0) & (cam_tri < torus)).any(1).sum() > B // 20
    assert (jr['env_lprim'] >= 0).sum() > B // 10


@pytest.fixture(scope='module')
def jax_subpath(setup):
    js, jo = setup[0], setup[1]
    o = jo.replace(use_light_coordinate_sampling=True)
    return o, jax.jit(lambda uu, ss, tt: jtrace.generate_subpath(
        js, o, jtrace.Tape(uu, D), ss, tt))


@pytest.mark.parametrize('slot', SUB_SLOTS)
def test_subpath_with_light_coords_matches_jax(setup, jax_subpath, slot):
    _, _, ts, u, _, _, _, _ = setup
    o, fn = jax_subpath
    s, t = slot
    jrec, jres = fn(jnp.asarray(u), jnp.full(B, s, jnp.int32),
                    jnp.full(B, t, jnp.int32))
    with torch.no_grad():
        trec, tres = trace.generate_subpath(
            ts, o, trace.Tape(torch.as_tensor(u), D),
            torch.full((B,), s, dtype=torch.int32),
            torch.full((B,), t, dtype=torch.int32))
    jv = np.asarray(jres['valid'])
    assert (to_np(tres['valid']) != jv).sum() <= B // 100
    for k in ('ls', 'ss', 'contrib', 'screen'):
        assert_close_most(to_np(tres[k]), np.asarray(jres[k]), RTOL,
                          err_msg=f'subpath {slot} {k}')
    assert_close_most(to_np(trec.cam_bsdf_rnd),
                      np.asarray(jrec.cam_bsdf_rnd), RTOL,
                      err_msg=f'subpath {slot} cam_bsdf_rnd')


@pytest.fixture(scope='module')
def jax_fns(setup):
    js, jo = setup[0], setup[1]

    @jax.jit
    def perturb(r, offset, noise):
        return jreplay.replay_path(js, jo, r, offset, noise, mode='perturb')

    @jax.jit
    def frozen(r, offset):
        return jreplay.replay_path(js, jo, r, offset, None, mode='frozen')

    @jax.jit
    def grad(r):
        return jreplay.path_grad(js, jo, r)

    return perturb, frozen, grad


@pytest.mark.parametrize('slot', SLOTS)
def test_perturb_and_frozen_replay_match_jax(setup, jax_fns, slot):
    _, jo, ts, _, rec, con, offset, noise = setup
    s, t = slot
    r = _tag(rec, s, t)
    jrec = _jax_rec(r)
    _, jp = jax_fns[0](jrec, jnp.asarray(offset),
                       {k: jnp.asarray(v) for k, v in noise.items()})
    _, jf = jax_fns[1](jrec, jnp.asarray(offset))
    with torch.no_grad():
        _, tp = replay.replay_path(
            ts, jo, r, torch.as_tensor(offset),
            {k: torch.as_tensor(v) for k, v in noise.items()})
        _, tf = replay.replay_path(ts, jo, r, torch.as_tensor(offset), None,
                                   mode='frozen')
    live = _gen_ss(con, s, t) > 1e-8
    assert live.sum() >= 3, f'too few paths on slot {slot}'
    for mode, got, want in (('perturb', tp, jp), ('frozen', tf, jf)):
        gv, wv = to_np(got['valid']), np.asarray(want['valid'])
        assert (gv != wv).sum() <= B // 100, mode
        for k in KEYS:
            assert_close_most(to_np(got[k]), np.asarray(want[k]), RTOL,
                              err_msg=f'{mode} {slot} {k}')


def test_bake_refused_on_a_moving_scene(setup):
    _, jo, ts, _, rec, _, _, _ = setup
    r = _tag(rec, 2, 1)
    with pytest.raises(ValueError, match='static'):
        replay.replay_path(ts, jo, r, torch.zeros(B, 2 * D), None,
                           mode='frozen', collect_bake=True)
    with pytest.raises(ValueError, match='static'):
        replay.bake_frozen(ts, jo, r)


@pytest.mark.parametrize('slot', [(2, 0), (3, 0), (2, 1), (1, 2)])
def test_path_grad_without_bake_matches_jax(setup, jax_fns, slot):
    _, jo, ts, _, rec, con, _, _ = setup
    s, t = slot
    r = _tag(rec, s, t)
    g = to_np(replay.path_grad(ts, jo, r))
    gj = np.asarray(jax_fns[2](_jax_rec(r)))
    live = _gen_ss(con, s, t) > 1e-6
    assert live.sum() >= 3 and np.abs(g[live]).max() > 0
    assert np.isfinite(g).all()
    assert_close_most(g[live], gj[live], 2e-2, atol=4e-4,
                      err_msg=f'path_grad {slot}')


def test_path_grad_hessian_without_bake_matches_jax(setup, jax_fns):
    """The port's gradient and Hessian against JAX's path_grad (compiled
    once for the batch; JAX's own Hessian takes minutes to compile on the
    CPU): the gradient lane by lane, each Hessian column against central
    differences of JAX's gradient over records shifted by +-eps in that
    PSS dimension (15% of the difference, or 2% of the lane's largest
    entry; columns whose difference jumps across a discontinuity are
    skipped), on lanes whose camera vertex reads no texture. At most 1%
    of the checked columns may disagree."""
    from langevin_mcmc_tpu.path.records import apply_pss_offset as japply
    _, jo, ts, _, rec, con, _, _ = setup
    s, t = 2, 1
    dim = 2 * (s + t - 1)
    r = _tag(rec, s, t)
    jrec = _jax_rec(r)
    # the frozen replay reads texture values as constants at each st, so
    # the gradient's differences step at texel edges: untextured lanes
    cam_mat = ts.tri_mat[torch.clamp(r.cam_tri[:, 0], min=0).long()].long()
    untextured = to_np((ts.mat_tex[cam_mat] < 0).all(1))
    lanes = np.nonzero((_gen_ss(con, s, t) > 1e-6) & untextured)[0][:48]
    assert len(lanes) >= 8
    sub = dataclasses.replace(r, **{f.name: getattr(r, f.name)[lanes]
                                    for f in dataclasses.fields(r)
                                    if f.name != 'max_depth'})
    g, h = replay.path_grad_hessian(ts, jo, sub)
    g, h = to_np(g), to_np(h)
    assert np.isfinite(g).all() and np.isfinite(h).all()
    assert np.abs(h).max() > 0
    gj = np.asarray(jax_fns[2](jrec))[lanes]
    assert_close_most(g, gj, 2e-2, atol=4e-4, err_msg='gradient')
    eps = 1e-3
    checked = bad = 0
    for k in range(dim):
        e = np.zeros((B, 2 * D), np.float32)
        e[:, k] = eps
        gp = np.asarray(jax_fns[2](japply(jrec, jnp.asarray(e))))[lanes]
        gm = np.asarray(jax_fns[2](japply(jrec, jnp.asarray(-e))))[lanes]
        fd = (gp - gm) / (2 * eps)
        for i in range(len(lanes)):
            scale = np.abs(h[i]).max()
            if not np.isfinite(fd[i]).all() \
                    or np.abs(fd[i]).max() > 10 * scale:
                continue
            tol = np.maximum(0.15 * np.abs(fd[i]), 0.02 * scale)
            checked += 1
            bad += int(not (np.abs(fd[i] - h[i, :, k])[:dim]
                            <= tol[:dim]).all())
    assert checked >= dim * len(lanes) // 2, checked
    assert bad <= checked // 100, f'{bad} of {checked} columns disagree'


def test_chain_gradients_skip_the_bake(setup):
    """The MALA step's derivative paths on a moving scene: the perturb
    replay without a bake and the proposal-side gradient equal path_grad
    on the replayed record; small_step_mala runs them (and its sparse
    current-side gradient) and gives MH ratios in [0, 1]."""
    _, jo, ts, _, rec, con, offset, noise = setup
    r = _tag(rec, 2, 1)
    off = torch.as_tensor(offset)
    nz = {k: torch.as_tensor(v) for k, v in noise.items()}
    with torch.no_grad():
        new_rec, res, grad, hess = chain._perturb_and_grad(
            ts, jo, r, off, nz, torch.ones(B, dtype=torch.bool))
        _, want = replay.replay_path(ts, jo, r, off, nz)
    assert hess is None
    for k in ('ss_score', 'contrib'):
        assert torch.equal(res[k], want[k])
    np.testing.assert_array_equal(to_np(grad),
                                  to_np(replay.path_grad(ts, jo, new_rec)))
    flat, s_tags, t_tags = con.flatten()
    pick = torch.argmax(flat['ls_score'], 1)
    ln = torch.arange(B)
    take = lambda a: a[ln, pick]
    st = chain.init_chain_state(
        to_subpath(rec, torch.as_tensor(s_tags)[pick],
                   torch.as_tensor(t_tags)[pick]),
        take(flat['contrib']), take(flat['screen_pos']),
        take(flat['ls_score']), take(flat['ss_score']),
        flat['ls_score'].sum(1), jo)
    st = dataclasses.replace(st, valid=torch.ones(B, dtype=torch.bool))
    o = jo.replace(num_chains=B, cur_grad_fraction=0.25)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        prop, a = chain.small_step_mala(
            ts, o, st, torch.randn((B, 2 * D), generator=gen),
            chain.perturb_noise(gen, B, D, o, 'cpu'),
            cache_mod.make_cache(o, 2 * D, 'cpu'))
    a = to_np(a)
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    assert (a > 0).sum() > B // 10
    assert to_np(prop['cur_ok']).any()
