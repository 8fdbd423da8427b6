"""Fixed-(s, t) generation (generate_subpath, the multiplexed large steps'
generator): the port against the JAX package from the same uniform tape,
in both MIS modes, and against the port's own bidirectional generator.

* Each of the 13 (s, t) slots of the JAX package's subpath test (s = 1 and
  t = D among them), bidirectional MIS, and the unidirectional mode
  (bidirectional=false: t in {0, 1}, power-2 MIS) on its slots, on lcbox
  and on the small generated box (both at D = 4). No camera ray of either
  scene sees the light, so slot (2, 0) checks that both packages find no
  path. One jitted JAX function with traced s and t serves every case of
  a scene and mode. Tolerance: rtol 3e-4 per lane, at most 1% of lanes
  beyond 10x rtol (a lane on a discrete threshold, a BSDF lobe pick or a
  triangle edge, takes the other branch: XLA and torch round f32
  differently, and the JAX side intersects through its matmul backend),
  the valid sets and the triangle records equal up to 1% of lanes, tags
  and PSS dimensions exact.
* Below the Russian-roulette depth, the subpath of a slot equals that slot
  of generate_path_bidir on the same tape, inside the port: rtol 3e-4,
  the same bounds.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.path import trace as jtrace
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.path import trace
from langevin_mcmc_tpu_torch.path.records import pss_dim
from torch_parity import LCBOX, port_scene, to_np, assert_close_most

torch.set_num_threads(1)
B = 512
D = 4
RTOL = 3e-4
SLOTS = [(2, 0), (3, 0), (4, 0), (2, 1), (3, 1), (2, 2), (3, 2), (2, 3),
         (1, 2), (1, 3), (5, 0), (4, 1), (1, 4)]
UNI_SLOTS = [(2, 0), (3, 0), (4, 0), (5, 0), (2, 1), (3, 1), (4, 1)]
KEYS = ('ls', 'ss', 'mis', 'contrib', 'screen')


@pytest.fixture(scope='module', params=['lcbox', 'small'])
def box(request, tmp_path_factory):
    xml = LCBOX if request.param == 'lcbox' else testscenes.write_scene(
        str(tmp_path_factory.mktemp('small')), small=True, width=64,
        height=48, max_depth=D)
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D)
    u = np.random.default_rng(7).random((B, jtrace.Tape.size(D)),
                                        dtype=np.float32)
    return js, jo, port_scene(js), u


@pytest.fixture(scope='module')
def jax_subpath(box):
    """The JAX generate_subpath, jitted once per MIS mode (s, t traced)."""
    js, jo, _, u = box
    fns = {}

    def run(bidir, s, t):
        if bidir not in fns:
            o = jo.replace(bidirectional=bidir)
            fns[bidir] = jax.jit(lambda uu, ss, tt: jtrace.generate_subpath(
                js, o, jtrace.Tape(uu, D), ss, tt))
        rec, res = fns[bidir](jnp.asarray(u), jnp.full(B, s, jnp.int32),
                              jnp.full(B, t, jnp.int32))
        return rec, {k: np.asarray(v) for k, v in res.items()}
    return run


def port_subpath(ts, opts, u, s, t):
    with torch.no_grad():
        rec, res = trace.generate_subpath(
            ts, opts, trace.Tape(torch.as_tensor(u), D),
            torch.full((B,), s, dtype=torch.int32),
            torch.full((B,), t, dtype=torch.int32))
    return rec, {k: to_np(v) for k, v in res.items()}


def _compare(got, want, slot):
    vg, vw = got['valid'], want['valid']
    assert (vg != vw).sum() <= B // 100, \
        f'{slot}: valid sets differ on {(vg != vw).sum()} lanes'
    m = vg & vw
    if not m.any():
        return
    for k in KEYS:
        assert_close_most(got[k][m], want[k][m], RTOL, err_msg=f'{slot} {k}')


@pytest.mark.parametrize('bidir,slot', [(True, x) for x in SLOTS]
                         + [(False, x) for x in UNI_SLOTS])
def test_subpath_matches_jax(box, jax_subpath, bidir, slot):
    js, jo, ts, u = box
    s, t = slot
    jrec, want = jax_subpath(bidir, s, t)
    rec, got = port_subpath(ts, jo.replace(bidirectional=bidir), u, s, t)
    assert want['valid'].sum() >= (3 if slot != (2, 0) else 0), \
        f'{slot}: too few JAX paths'
    _compare(got, want, slot)
    assert (to_np(rec.cam_depth) == s).all()
    assert (to_np(rec.lgt_depth) == t).all()
    assert (to_np(pss_dim(rec)) == 2 * (s + t - 1)).all()
    for k in ('cam_tri', 'lgt_tri'):
        same = (to_np(getattr(rec, k)) == np.asarray(getattr(jrec, k))).all(1)
        assert (~same).sum() <= B // 100, f'{slot} {k}'


def test_subpath_mixed_lanes_match_jax(box, jax_subpath):
    """Per-lane (s, t): each lane reproduces the JAX lane of its own slot."""
    js, jo, ts, u = box
    pick = np.arange(B) % len(SLOTS)
    s = np.array([SLOTS[i][0] for i in pick], np.int32)
    t = np.array([SLOTS[i][1] for i in pick], np.int32)
    fn = jax.jit(lambda uu, ss, tt: jtrace.generate_subpath(
        js, jo, jtrace.Tape(uu, D), ss, tt))
    _, want = fn(jnp.asarray(u), jnp.asarray(s), jnp.asarray(t))
    want = {k: np.asarray(v) for k, v in want.items()}
    with torch.no_grad():
        _, got = trace.generate_subpath(ts, jo, trace.Tape(torch.as_tensor(u),
                                                           D),
                                        torch.as_tensor(s), torch.as_tensor(t))
    _compare({k: to_np(v) for k, v in got.items()}, want, 'mixed')


@pytest.fixture(scope='module')
def port_bidir(box):
    js, jo, ts, u = box
    with torch.no_grad():
        _, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=-1)
    return con


@pytest.mark.parametrize('slot', SLOTS)
def test_subpath_matches_own_bidir_slot(box, port_bidir, slot):
    js, jo, ts, u = box
    s, t = slot
    con = port_bidir
    if s >= 2:
        want = dict(ls=con.ls_score[:, s - 2, t], ss=con.ss_score[:, s - 2, t],
                    mis=con.mis_weight[:, s - 2, t],
                    contrib=con.contrib[:, s - 2, t],
                    screen=con.screen_pos[:, s - 2, t])
    else:
        want = dict(ls=con.l_ls_score[:, t - 2], ss=con.l_ss_score[:, t - 2],
                    mis=con.l_mis_weight[:, t - 2],
                    contrib=con.l_contrib[:, t - 2],
                    screen=con.l_screen_pos[:, t - 2])
    want = {k: to_np(v) for k, v in want.items()}
    want['valid'] = want['ls'] > 0.0
    assert want['valid'].sum() >= (3 if slot != (2, 0) else 0), \
        f'{slot}: too few bidir paths'
    _, got = port_subpath(ts, jo, u, s, t)
    _compare(got, want, slot)
