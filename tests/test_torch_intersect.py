"""The chunk walk's plain version (the CPU side of kernels K1/K2) against
the JAX package.

* Against JAX intersect_chunkwalk, run through its VMEM-resident variant
  in interpret mode (the only way the JAX walk runs on a CPU, as in
  tests/test_intersect.py): equal hit sets and triangle ids — the same
  tables, the same tie rules — and t, u, v within atol 5e-4 / 2e-3: the
  Woop projection O = o.b - c cancels large terms, and XLA contracts and
  reorders its f32 products differently from torch's op-by-op rounding
  (measured up to 2.2e-4 in t on this scene).
* Against JAX intersect_bruteforce (Moller-Trumbore, another formula):
  equal hit sets, the same triangle on at least 99.5% of hits (shared
  edges), t within rtol 2e-4, occlusion equal.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernel.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import intersect as jax_isect
from langevin_mcmc_tpu.ops import chunkwalk as jax_cw
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
from langevin_mcmc_tpu_torch.ops import intersect as isect
from torch_parity import port_scene, to_np

torch.set_num_threads(1)
N_RAYS = 600


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48, max_depth=4)
    js, _, _ = jax_parse(xml)
    ts = port_scene(js)
    assert ts.cw.pack.shape[0] >= 4
    return js, ts


@pytest.fixture(scope='module')
def rays(scenes):
    """Rays leaving random surface points in random directions, 30% dead
    (max_t = 0 < min_t), as numpy arrays. min_t = 1e-2 keeps the grazing
    self-hits of the curved torus, whose f32 t is noise, out of the
    comparison."""
    js, _ = scenes
    rng = np.random.default_rng(17)
    tp = np.asarray(js.tri_p)[0]
    tri = rng.integers(0, tp.shape[0], N_RAYS)
    b1, b2 = rng.uniform(0, 1, N_RAYS), rng.uniform(0, 1, N_RAYS)
    fl = b1 + b2 > 1
    b1, b2 = np.where(fl, 1 - b1, b1), np.where(fl, 1 - b2, b2)
    p = tp[tri]
    org = (p[:, 0] * (1 - b1 - b2)[:, None] + p[:, 1] * b1[:, None]
           + p[:, 2] * b2[:, None]).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(0, 1, N_RAYS) < 0.7
    mn = np.full(N_RAYS, 1e-2, np.float32)
    mx = np.where(alive, np.inf, 0.0).astype(np.float32)
    return org, d, mn, mx


@pytest.fixture(scope='module')
def port_out(scenes, rays):
    _, ts = scenes
    t = [torch.as_tensor(x) for x in rays]
    z = torch.zeros(N_RAYS)
    with torch.no_grad():
        return ([to_np(x) for x in
                 cw.intersect_chunkwalk(ts, t[0], t[1], z, t[2], t[3])],
                to_np(cw.occluded_chunkwalk(ts, t[0], t[1], z, t[2], t[3])))


def _jax_args(rays):
    org, d, mn, mx = (jnp.asarray(x) for x in rays)
    return org, d, jnp.zeros(N_RAYS), mn, mx


def test_plain_walk_matches_jax_chunkwalk(scenes, rays, port_out,
                                          monkeypatch):
    js, _ = scenes
    monkeypatch.setattr(jax_cw, 'VMEM_RESIDENT_BYTES', 6 * 1024 * 1024)
    hj, tj, ttj, uj, vj = (np.asarray(x) for x in
                           jax_cw.intersect_chunkwalk(js, *_jax_args(rays)))
    (hp, tp, ttp, up, vp), occ = port_out
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(tp[hp], tj[hj])
    np.testing.assert_allclose(ttp[hp], ttj[hj], rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(up[hp], uj[hj], atol=2e-3)
    np.testing.assert_allclose(vp[hp], vj[hj], atol=2e-3)
    occ_j = np.asarray(jax_cw.occluded_chunkwalk(js, *_jax_args(rays)))
    np.testing.assert_array_equal(occ, occ_j)


def test_plain_walk_matches_jax_bruteforce(scenes, rays, port_out):
    js, _ = scenes
    hb, tb, ttb, _, _ = (np.asarray(x) for x in
                         jax_isect.intersect_bruteforce(js, *_jax_args(rays)))
    (hp, tp, ttp, _, _), occ = port_out
    np.testing.assert_array_equal(hp, hb)
    same = tp == tb
    assert same[hb].mean() >= 0.995
    sel = hb & same
    np.testing.assert_allclose(ttp[sel], ttb[sel], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(occ, hb)
    assert (~hp[rays[3] == 0]).all(), 'a dead ray hit something'


def test_port_bruteforce_matches_jax(scenes, rays):
    js, ts = scenes
    t = [torch.as_tensor(x) for x in rays]
    hp, tp, ttp, _, _ = (to_np(x) for x in isect.intersect_bruteforce(
        ts, t[0], t[1], torch.zeros(N_RAYS), t[2], t[3]))
    hb, tb, ttb, _, _ = (np.asarray(x) for x in
                         jax_isect.intersect_bruteforce(js, *_jax_args(rays)))
    np.testing.assert_array_equal(hp, hb)
    assert (tp == tb)[hb].mean() >= 0.995
    np.testing.assert_allclose(ttp[hb], ttb[hb], rtol=2e-4, atol=2e-4)


def test_ray_sort_and_block_lists_match_jax(scenes, rays):
    """Padding, dead-last ray order and the per-block ascending chunk lists
    equal the JAX stages exactly."""
    js, ts = scenes
    org, d, mn, mx = (torch.as_tensor(x) for x in rays)
    (o, dd, rng), order = cw.sort_rays(ts.cw, org, d, mn, mx)
    chunk_idx, counts = cw._block_chunk_lists(o, dd, rng[:, 0], rng[:, 1],
                                              ts.cw.chunk_lo, ts.cw.chunk_hi)
    Rp = o.shape[0]
    pad = Rp - N_RAYS
    jo = jnp.pad(jnp.asarray(rays[0]), ((0, pad), (0, 0)))
    jd = jnp.pad(jnp.asarray(rays[1]), ((0, pad), (0, 0)),
                 constant_values=1.0)
    jmn = jnp.pad(jnp.asarray(rays[2]), (0, pad), constant_values=1.0)
    jmx = jnp.pad(jnp.asarray(rays[3]), (0, pad), constant_values=0.0)
    jmx = jnp.where(jnp.isinf(jmx), jax_cw.BIG, jmx)
    _, clo, chi, _, _ = jax_cw._prep_tables(js)
    jorder = np.asarray(jax_cw._sort_rays(
        jnp.asarray(clo.min(0)), jnp.asarray(chi.max(0)), jo, jd,
        alive=jmx >= jmn))
    np.testing.assert_array_equal(to_np(order), jorder)
    jidx, jcounts = jax_cw._block_chunk_lists(
        jo[jorder], jd[jorder], jmn[jorder], jmx[jorder], jnp.asarray(clo),
        jnp.asarray(chi))
    np.testing.assert_array_equal(to_np(counts), np.asarray(jcounts))
    jidx = np.asarray(jidx)
    for b, n in enumerate(to_np(counts)):
        np.testing.assert_array_equal(to_np(chunk_idx)[b, :n], jidx[b, :n])
        assert (np.diff(jidx[b, :n]) > 0).all()
    # dead rays sort last, so the trailing blocks have empty lists
    assert to_np(counts)[-1] == 0

