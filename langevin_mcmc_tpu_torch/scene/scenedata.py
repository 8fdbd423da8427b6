"""Device-resident scene: struct-of-arrays tensors over all triangles,
materials and lights (port of scene/scenedata.py).

The scene is built from a dict of host (numpy) arrays whose keys are the
JAX ``SceneData`` field names, so the parser and ``interop`` share one
constructor. Triangle ids and other integer data stay int32 tensors beside
the f32 tables (the JAX package stores some of them in f32 rows, exact only
below 2**24).
"""

import dataclasses

import numpy as np
import torch

from .camera import Camera, camera_from_arrays

BSDF_LAMBERTIAN = 0
BSDF_PHONG = 1
BSDF_ROUGH_DIELECTRIC = 2

LIGHT_POINT = 0
LIGHT_AREA = 1
LIGHT_ENV = 2

# host arrays a scene is built from, by JAX SceneData field name
HOST_FIELDS = (
    'tri_p', 'tri_n', 'tri_st', 'tri_mat', 'tri_shape', 'tri_light',
    'mat_type', 'mat_twosided', 'mat_kd', 'mat_kd_tex', 'mat_ks',
    'mat_ks_tex', 'mat_exponent', 'mat_exponent_tex', 'mat_ks_weight',
    'mat_alpha_tex',
    'light_type', 'light_weight', 'light_cdf', 'light_emission',
    'light_tri', 'light_tri_cdf', 'light_tri_pmf', 'light_ntri',
    'light_inv_area', 'bsphere_center', 'bsphere_radius',
    'isect_B', 'isect_C', 'isect_ok')


@dataclasses.dataclass
class ChunkWalkTables:
    """Morton-ordered packed triangle chunks of TC triangles: 128 for the
    chunk walk (``ops/chunkwalk.py``), 512 for the culled sweep
    (``ops/sweep_isect.py``)."""
    pack: torch.Tensor       # [K, 16, TC] f32 (rows 0-8 frame, 9-11 trans, 12 valid)
    ids: torch.Tensor        # [K, TC] int32 original triangle ids
    chunk_lo: torch.Tensor   # [K, 3]
    chunk_hi: torch.Tensor   # [K, 3]
    scene_lo: torch.Tensor   # [3] corner of the box the ray sort quantises
    scene_hi: torch.Tensor   # [3]


@dataclasses.dataclass
class SceneData:
    tri_p: torch.Tensor        # [2, T, 3, 3] (static: both keyframes equal)
    tri_n: torch.Tensor        # [2, T, 3, 3]
    tri_st: torch.Tensor       # [T, 3, 2]
    tri_mat: torch.Tensor      # [T] int32
    tri_light: torch.Tensor    # [T] int32, -1 if not an area light
    tri_geom: torch.Tensor     # [T, 24] p0 e1 e2 n0..n2 st0..st2
    mat_type: torch.Tensor     # [M] int32
    mat_twosided: torch.Tensor  # [M] bool
    mat_kd: torch.Tensor       # [M, 3]
    mat_ks: torch.Tensor       # [M, 3]
    mat_exponent: torch.Tensor  # [M]
    mat_ks_weight: torch.Tensor  # [M]
    light_type: torch.Tensor   # [L] int32
    light_weight: torch.Tensor  # [L]
    light_cdf: torch.Tensor    # [L+1]
    light_emission: torch.Tensor  # [L, 3]
    light_tri: torch.Tensor    # [L, Amax] int32
    light_tri_cdf: torch.Tensor  # [L, Amax+1]
    light_ntri: torch.Tensor   # [L] int32
    light_inv_area: torch.Tensor  # [L]
    bsphere_center: torch.Tensor  # [3]
    bsphere_radius: float
    camera: Camera
    cw: ChunkWalkTables
    sweep: ChunkWalkTables
    num_tris: int
    num_lights: int
    width: int
    height: int
    light_weight_sum: float
    device: torch.device


def check_supported(host):
    """Reject scene content outside the ported configuration."""
    mt = np.asarray(host['mat_type'])
    if (mt == BSDF_ROUGH_DIELECTRIC).any():
        raise NotImplementedError('roughdielectric BSDF is not ported yet')
    for k in ('mat_kd_tex', 'mat_ks_tex', 'mat_exponent_tex',
              'mat_alpha_tex'):
        if k in host and (np.asarray(host[k]) >= 0).any():
            raise NotImplementedError('bitmap textures are not ported yet')
    lt = np.asarray(host['light_type'])
    if (lt == LIGHT_POINT).any():
        raise NotImplementedError('point emitters are not ported yet')
    if (lt == LIGHT_ENV).any():
        raise NotImplementedError('envmap emitters are not ported yet')
    tp = np.asarray(host['tri_p'])
    if not np.array_equal(tp[0], tp[1]):
        raise NotImplementedError('moving geometry is not ported yet')
    cam = host['camera']
    if not (np.array_equal(cam['c2w_trans'][0], cam['c2w_trans'][1])
            and np.array_equal(cam['c2w_quat'][0], cam['c2w_quat'][1])):
        raise NotImplementedError('camera motion is not ported yet')


def build_tri_geom(tri_p0, tri_n0, tri_st):
    """[T, 24] f32: p0(0:3) e1(3:6) e2(6:9) n0..n2(9:18) st0..st2(18:24)
    — columns 0-23 of the JAX packed geometry row; material and light ids
    stay in the int32 tri_mat / tri_light tensors."""
    T = tri_p0.shape[0]
    g = np.zeros((T, 24), np.float32)
    g[:, 0:3] = tri_p0[:, 0]
    g[:, 3:6] = tri_p0[:, 1] - tri_p0[:, 0]
    g[:, 6:9] = tri_p0[:, 2] - tri_p0[:, 0]
    g[:, 9:18] = tri_n0.reshape(T, 9)
    g[:, 18:24] = tri_st.reshape(T, 6)
    return g


def build_scene(host, device='cuda'):
    """SceneData on `device` from host arrays (keys: HOST_FIELDS plus
    'camera', a dict of camera_arrays). The default is the card; a machine
    without one must ask for device='cpu'."""
    from ..ops import chunkwalk, sweep_isect
    check_supported(host)
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "scene on the CPU")
    f32 = lambda k: torch.as_tensor(np.array(host[k], np.float32),
                                    device=device)
    i32 = lambda k: torch.as_tensor(np.array(host[k], np.int32),
                                    device=device)
    tri_p = np.asarray(host['tri_p'], np.float32)
    tri_n = np.asarray(host['tri_n'], np.float32)
    tri_st = np.asarray(host['tri_st'], np.float32)
    woop = (np.asarray(host['isect_B']), np.asarray(host['isect_C']),
            np.asarray(host['isect_ok']), tri_p[0])
    t = lambda a: torch.as_tensor(a, device=device)
    pack, ids, clo, chi = chunkwalk.prep_tables(*woop)
    cw = ChunkWalkTables(
        pack=t(pack), ids=t(ids), chunk_lo=t(clo), chunk_hi=t(chi),
        scene_lo=t(clo.min(0)), scene_hi=t(chi.max(0)))
    # the sweep sorts rays in the vertex bounding box, as the JAX sweep does
    pack, ids, clo, chi = sweep_isect.prep_tables(*woop)
    verts = tri_p[0].reshape(-1, 3)
    sweep = ChunkWalkTables(
        pack=t(pack), ids=t(ids), chunk_lo=t(clo), chunk_hi=t(chi),
        scene_lo=t(verts.min(0)), scene_hi=t(verts.max(0)))
    cam = camera_from_arrays(host['camera'], device)
    lw = np.asarray(host['light_weight'], np.float32)
    return SceneData(
        tri_p=f32('tri_p'), tri_n=f32('tri_n'), tri_st=f32('tri_st'),
        tri_mat=i32('tri_mat'), tri_light=i32('tri_light'),
        tri_geom=t(build_tri_geom(tri_p[0], tri_n[0], tri_st)),
        mat_type=i32('mat_type'),
        mat_twosided=torch.as_tensor(np.array(host['mat_twosided'], bool),
                                     device=device),
        mat_kd=f32('mat_kd'), mat_ks=f32('mat_ks'),
        mat_exponent=f32('mat_exponent'), mat_ks_weight=f32('mat_ks_weight'),
        light_type=i32('light_type'), light_weight=f32('light_weight'),
        light_cdf=f32('light_cdf'), light_emission=f32('light_emission'),
        light_tri=i32('light_tri'), light_tri_cdf=f32('light_tri_cdf'),
        light_ntri=i32('light_ntri'), light_inv_area=f32('light_inv_area'),
        bsphere_center=f32('bsphere_center'),
        bsphere_radius=float(np.float32(host['bsphere_radius'])),
        camera=cam, cw=cw, sweep=sweep, num_tris=int(tri_p.shape[1]),
        num_lights=int(host['num_lights']), width=cam.width,
        height=cam.height, light_weight_sum=float(lw.sum()),
        device=device)
