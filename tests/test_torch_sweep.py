"""The culled sweep's plain version (the CPU side of kernel K4) against the
JAX package's Pallas sweep, and the port's intersection backend switch.

* Tables, ray order and the per-(block, chunk) visit mask equal the JAX
  stages exactly (the same numpy table code, the same integer sort keys,
  the same f32 slab test).
* Against JAX intersect_pallas / occluded_pallas, which run in interpret
  mode on a CPU: equal hit sets, the same triangle on at least 99.5% of
  hits, t within rtol 2e-4, occlusion equal. The ids may differ on a
  shared edge and t by rounding: XLA contracts and reorders the Woop
  projection's f32 products, torch rounds op by op (up to 2.2e-4 in t on
  this scene), so min_t = 1e-2 keeps the grazing self-hits, whose t is
  noise, out of the comparison.
* Against the port's own chunk walk: equal hit sets and bit-identical t
  (the same Woop arithmetic in the same order); ids equal except on exact
  ties of t, which the 128- and 512-triangle chunking resolve apart.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernel.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import pallas_isect as jax_sweep
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
from langevin_mcmc_tpu_torch.ops import intersect as isect
from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
from langevin_mcmc_tpu_torch.ops import tracing
from torch_parity import port_scene, to_np

torch.set_num_threads(1)
N_RAYS = 2048


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48, max_depth=4)
    js, _, _ = jax_parse(xml)
    ts = port_scene(js)
    assert ts.sweep.pack.shape[0] >= 3
    return js, ts


@pytest.fixture(scope='module')
def rays(scenes):
    """Rays leaving random surface points in random directions, 30% dead
    (max_t = 0 < min_t), as numpy arrays."""
    js, _ = scenes
    rng = np.random.default_rng(23)
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


def _torch(rays):
    return [torch.as_tensor(x) for x in rays]


@pytest.fixture(scope='module')
def port_out(scenes, rays):
    _, ts = scenes
    o, d, mn, mx = _torch(rays)
    z = torch.zeros(N_RAYS)
    tracing.reset_launches()
    with torch.no_grad():
        out = ([to_np(x) for x in sw.intersect_sweep(ts, o, d, z, mn, mx)],
               to_np(sw.occluded_sweep(ts, o, d, z, mn, mx)))
    # CPU tensors run the plain version: no kernel launch is counted
    assert sw.launch_counts == {'closest_hit': 0, 'any_hit': 0}
    return out


def test_tables_match_jax(scenes):
    js, ts = scenes
    rows, c_rows, okp, ids, clo, chi, T, Tp = jax_sweep._prep_tables(js)
    K = Tp // sw.TRI_CHUNK
    pack = to_np(ts.sweep.pack)
    assert pack.shape == (K, 16, sw.TRI_CHUNK)
    flat = pack.transpose(1, 0, 2).reshape(16, Tp)
    np.testing.assert_array_equal(flat[0:9], rows)
    np.testing.assert_array_equal(flat[9:12], c_rows)
    np.testing.assert_array_equal(flat[12], okp)
    np.testing.assert_array_equal(to_np(ts.sweep.ids).reshape(-1), ids)
    np.testing.assert_array_equal(to_np(ts.sweep.chunk_lo), clo)
    np.testing.assert_array_equal(to_np(ts.sweep.chunk_hi), chi)


def test_ray_sort_and_mask_match_jax(scenes, rays):
    js, ts = scenes
    (o, d, rng), order = sw.prepare_rays(ts.sweep, *_torch(rays))
    mask = sw._chunk_mask(o, d, rng[:, 0], rng[:, 1], ts.sweep.chunk_lo,
                          ts.sweep.chunk_hi)
    pad = o.shape[0] - N_RAYS
    jo = jnp.pad(jnp.asarray(rays[0]), ((0, pad), (0, 0)))
    jd = jnp.pad(jnp.asarray(rays[1]), ((0, pad), (0, 0)),
                 constant_values=1.0)
    jmn = jnp.pad(jnp.asarray(rays[2]), (0, pad), constant_values=1.0)
    jmx = jnp.pad(jnp.asarray(rays[3]), (0, pad), constant_values=0.0)
    jmx = jnp.where(jnp.isinf(jmx), jax_sweep.BIG, jmx)
    jorder = np.asarray(jax_sweep._sort_rays(js, jo, jd))
    np.testing.assert_array_equal(to_np(order), jorder)
    _, _, _, _, clo, chi, _, _ = jax_sweep._prep_tables(js)
    jmask = jax_sweep._chunk_mask(jo[jorder], jd[jorder], jmn[jorder],
                                  jmx[jorder], jnp.asarray(clo),
                                  jnp.asarray(chi))
    np.testing.assert_array_equal(to_np(mask), np.asarray(jmask))
    assert tuple(mask.shape) == (o.shape[0] // 256, ts.sweep.pack.shape[0])


def test_plain_sweep_matches_jax_pallas(scenes, rays, port_out):
    js, _ = scenes
    args = (*(jnp.asarray(x) for x in rays[:2]), jnp.zeros(N_RAYS),
            *(jnp.asarray(x) for x in rays[2:]))
    hj, tj, ttj, _, _ = (np.asarray(x) for x in
                         jax_sweep.intersect_pallas(js, *args))
    (hp, tp, ttp, _, _), occ = port_out
    np.testing.assert_array_equal(hp, hj)
    assert hp.sum() > N_RAYS // 4
    same = tp == tj
    assert same[hj].mean() >= 0.995
    sel = hj & same
    np.testing.assert_allclose(ttp[sel], ttj[sel], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(occ, np.asarray(
        jax_sweep.occluded_pallas(js, *args)))
    assert (~hp[rays[3] == 0]).all(), 'a dead ray hit something'


def test_plain_sweep_matches_chunk_walk(scenes, rays, port_out):
    _, ts = scenes
    o, d, mn, mx = _torch(rays)
    z = torch.zeros(N_RAYS)
    with torch.no_grad():
        hc, tc, ttc, _, _ = (to_np(x) for x in
                             cw.intersect_chunkwalk(ts, o, d, z, mn, mx))
        occ_c = to_np(cw.occluded_chunkwalk(ts, o, d, z, mn, mx))
    (hp, tp, ttp, _, _), occ = port_out
    np.testing.assert_array_equal(hp, hc)
    np.testing.assert_array_equal(ttp[hp], ttc[hc])
    assert (tp == tc)[hp].mean() >= 0.999
    np.testing.assert_array_equal(occ, occ_c)
    np.testing.assert_array_equal(occ, hp)


@pytest.mark.parametrize('backend, name, resident', [
    ('', 'intersect_chunkwalk', False),
    ('chunkwalk', 'intersect_chunkwalk', False),
    ('pallas', 'intersect_sweep', None),
    ('brute', 'intersect_bruteforce', None),
    ('matmul', 'intersect_matmul', None)])
def test_backend_switch(scenes, monkeypatch, backend, name, resident):
    _, ts = scenes
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', backend)
    monkeypatch.delenv('LMC_CW_VMEM_BYTES', raising=False)
    fi, fo = isect.make_intersect_fns(ts)
    assert fi.func.__name__ == name
    assert fo.func.__name__ == name.replace('intersect', 'occluded')
    assert fi.keywords.get('resident') == resident
    if backend in ('', 'chunkwalk'):
        # read on each call: a pack under LMC_CW_VMEM_BYTES is resident
        nbytes = ts.cw.pack.numel() * 4
        monkeypatch.setenv('LMC_CW_VMEM_BYTES', str(nbytes))
        assert isect.make_intersect_fns(ts)[0].keywords['resident'] is True
        monkeypatch.setenv('LMC_CW_VMEM_BYTES', str(nbytes - 1))
        assert isect.make_intersect_fns(ts)[1].keywords['resident'] is False


def test_backend_switch_rejects_matmul(scenes, monkeypatch):
    """The switch once refused 'matmul'; the matmul sweep is ported, so
    the name routes to it, and a name the switch does not know is
    refused."""
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'matmul')
    fi, fo = isect.make_intersect_fns(scenes[1])
    assert fi.func is isect.intersect_matmul
    assert fo.func is isect.occluded_matmul
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'mxu')
    with pytest.raises(ValueError, match='mxu'):
        isect.make_intersect_fns(scenes[1])
