"""Device-resident scene: struct-of-arrays tensors over all triangles,
materials and lights (port of scene/scenedata.py).

The scene is built from a dict of host (numpy) arrays whose keys are the
JAX ``SceneData`` field names, so the parser and ``interop`` share one
constructor. Triangle ids and other integer data stay int32 tensors beside
the f32 tables (the JAX package stores some of them in f32 rows, exact only
below 2**24). The environment tables and the bounding sphere are built on
the host in numpy, as in the JAX package, so both packages hold the same
bits.
"""

import dataclasses

import numpy as np
import torch

from .camera import Camera, camera_from_arrays
from .textures import TexturePack, texture_pack

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
    'mat_eta', 'mat_inv_eta', 'mat_alpha', 'mat_alpha_tex',
    'light_type', 'light_weight', 'light_cdf', 'light_pos',
    'light_emission', 'light_tri', 'light_tri_cdf', 'light_tri_pmf',
    'light_ntri', 'light_inv_area',
    'env_image', 'env_neigh', 'env_rw2', 'env_cdf_rows', 'env_cdf_cols',
    'env_row_weights', 'env_normalization', 'env_pixel_size',
    'env_to_world_t', 'env_to_world_q', 'env_to_light_t', 'env_to_light_q',
    'bsphere_center', 'bsphere_radius')

# material texture slots, in the order of MatParams' textured fields
TEX_SLOTS = ('mat_kd_tex', 'mat_ks_tex', 'mat_exponent_tex', 'mat_alpha_tex')


@dataclasses.dataclass
class SceneData:
    tri_p: torch.Tensor        # [2, T, 3, 3] keyframes 0 and 1
    tri_n: torch.Tensor        # [2, T, 3, 3]
    tri_st: torch.Tensor       # [T, 3, 2]
    tri_mat: torch.Tensor      # [T] int32
    tri_light: torch.Tensor    # [T] int32, -1 if not an area light
    tri_geom: torch.Tensor     # [T, 24] p0 e1 e2 n0..n2 st0..st2, keyframe 0
    mat_type: torch.Tensor     # [M] int32
    mat_twosided: torch.Tensor  # [M] bool
    mat_kd: torch.Tensor       # [M, 3] (Kt for roughdielectric)
    mat_ks: torch.Tensor       # [M, 3]
    mat_exponent: torch.Tensor  # [M]
    mat_ks_weight: torch.Tensor  # [M]
    mat_eta: torch.Tensor      # [M]
    mat_inv_eta: torch.Tensor  # [M]
    mat_alpha: torch.Tensor    # [M]
    mat_tex: torch.Tensor      # [M, 4] int32 texture ids (TEX_SLOTS), -1 none
    tex_slots: tuple           # 4 bools: does any material bind that slot
    mat_types: tuple           # the BSDF types of the scene's materials
    light_type: torch.Tensor   # [L] int32
    light_types: tuple         # the light types of the scene
    light_weight: torch.Tensor  # [L]
    light_cdf: torch.Tensor    # [L+1]
    light_pos: torch.Tensor    # [L, 3] point-light position
    light_emission: torch.Tensor  # [L, 3] point intensity / area radiance
    light_tri: torch.Tensor    # [L, Amax] int32
    light_tri_cdf: torch.Tensor  # [L, Amax+1]
    light_ntri: torch.Tensor   # [L] int32
    light_inv_area: torch.Tensor  # [L]
    # environment light (at most one; placeholder tables without one)
    env_image: torch.Tensor     # [He, We, 3]
    env_neigh: torch.Tensor     # [He, We, 12] packed 2x2 neighbourhoods
    env_rw2: torch.Tensor       # [He+2, 2] row weights of row, row+1
    env_cdf_rows: torch.Tensor  # [He+1]
    env_cdf_cols: torch.Tensor  # [He, We+1]
    env_row_weights: torch.Tensor  # [He]
    env_normalization: float
    env_pixel_size: torch.Tensor  # [2]
    env_to_world_t: torch.Tensor  # [2, 3]
    env_to_world_q: torch.Tensor  # [2, 4]
    env_to_light_t: torch.Tensor  # [2, 3]
    env_to_light_q: torch.Tensor  # [2, 4]
    env_light_id: int           # -1 without an env light
    # scene bounding sphere, radius x1000
    bsphere_center: torch.Tensor  # [3]
    bsphere_radius: float
    env_position_pdf: float    # 1 / (pi radius^2), in f32 as the JAX package
    camera: Camera
    textures: TexturePack
    has_motion: bool           # a shape moves between the keyframes
    num_tris: int
    num_lights: int
    width: int
    height: int
    light_weight_sum: float
    device: torch.device


def build_env_sample_info(img):
    """Row/column CDF tables of the env map's importance sampling: (cdf_rows
    [H+1], cdf_cols [H, W+1], row_weights [H], normalization, pixel_size
    [2]), f32, computed in float64."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    lum = (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
           + 0.072169 * img[..., 2])
    col_sum = lum.sum(1)
    cdf_cols = np.zeros((h, w + 1))
    np.cumsum(lum, 1, out=cdf_cols[:, 1:])
    safe = np.where(col_sum > 0, col_sum, 1.0)
    cdf_cols /= safe[:, None]
    cdf_cols[:, -1] = 1.0
    row_weights = np.sin((np.arange(h) + 0.5) * np.pi / h)
    weighted = col_sum * row_weights
    row_sum = weighted.sum()
    cdf_rows = np.zeros(h + 1)
    np.cumsum(weighted, out=cdf_rows[1:])
    cdf_rows /= row_sum
    cdf_rows[-1] = 1.0
    normalization = 1.0 / (row_sum * (2.0 * np.pi / w) * (np.pi / h))
    pixel_size = np.array([2.0 * np.pi / w, np.pi / h])
    return (cdf_rows.astype(np.float32), cdf_cols.astype(np.float32),
            row_weights.astype(np.float32), np.float32(normalization),
            pixel_size.astype(np.float32))


def _env_neighborhoods(img):
    """[H, W, 12] of (v00, v10, v01, v11) with periodic wrap: one gather
    per bilinear lookup."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    xr = (np.arange(w) + 1) % w
    yr = (np.arange(h) + 1) % h
    return np.concatenate([img, img[:, xr], img[yr], img[yr][:, xr]], -1)


def _env_rw_pairs(row_w):
    """[H+2, 2] of (rw[clip(row)], rw[clip(row+1)]) indexed by row+1 for
    row in [-1, H]: the row weights clip, where the texels wrap."""
    row_w = np.asarray(row_w, np.float32)
    h = row_w.shape[0]
    rows = np.arange(-1, h + 1)
    rw0 = row_w[np.clip(rows, 0, h - 1)]
    rw1 = row_w[np.clip(rows + 1, 0, h - 1)]
    return np.stack([rw0, rw1], -1)


def env_host_arrays(img, to_world):
    """The env_* host arrays of an env map image [H, W, 3] and its
    AnimatedTransform; img None gives the no-env placeholder tables."""
    from . import transforms as T
    f32 = np.float32
    if img is not None:
        img = np.asarray(img).astype(f32)
        cdf_rows, cdf_cols, row_w, norm, pix = build_env_sample_info(img)
        tl = to_world.inverse()
    else:
        img = np.zeros((1, 2, 3), f32)
        cdf_rows = np.array([0, 1], f32)
        cdf_cols = np.array([[0, 0.5, 1]], f32)
        row_w = np.ones(1, f32)
        norm = f32(1.0)
        pix = np.array([2 * np.pi / 2, np.pi], f32)
        to_world = tl = T.AnimatedTransform(np.eye(4))
    ewt, ewq = to_world.as_arrays()
    elt, elq = tl.as_arrays()
    return dict(env_image=img, env_neigh=_env_neighborhoods(img),
                env_rw2=_env_rw_pairs(row_w), env_cdf_rows=cdf_rows,
                env_cdf_cols=cdf_cols, env_row_weights=row_w,
                env_normalization=norm, env_pixel_size=pix,
                env_to_world_t=ewt, env_to_world_q=ewq,
                env_to_light_t=elt, env_to_light_q=elq)


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


def build_scene(host, device='cpu', dtype=torch.float32):
    """SceneData on `device` from host arrays (keys: HOST_FIELDS plus
    'num_lights', 'env_light_id', 'has_motion', 'camera', a dict of
    camera_arrays, and 'textures', a dict of TextureBuilder.host_arrays()),
    every float table in `dtype` (float32 for the reference, a lower
    precision for its control). No acceleration table is built: every
    query is the brute force."""
    device = torch.device(device)
    f32 = lambda k: torch.as_tensor(np.array(host[k], np.float32),
                                    device=device).to(dtype)
    i32 = lambda k: torch.as_tensor(np.array(host[k], np.int32),
                                    device=device)
    tri_p = np.array(host['tri_p'], np.float32, order='C')
    tri_n = np.asarray(host['tri_n'], np.float32)
    tri_st = np.asarray(host['tri_st'], np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    cam = camera_from_arrays(host['camera'], device, dtype)
    lw = np.asarray(host['light_weight'], np.float32)
    radius = np.float32(host['bsphere_radius'])
    mat_tex = np.stack([np.asarray(host[k], np.int32) for k in TEX_SLOTS], 1)
    return SceneData(
        tri_p=t(tri_p).to(dtype), tri_n=f32('tri_n'), tri_st=f32('tri_st'),
        tri_mat=i32('tri_mat'), tri_light=i32('tri_light'),
        tri_geom=t(build_tri_geom(tri_p[0], tri_n[0], tri_st)).to(dtype),
        mat_type=i32('mat_type'),
        mat_twosided=torch.as_tensor(np.array(host['mat_twosided'], bool),
                                     device=device),
        mat_kd=f32('mat_kd'), mat_ks=f32('mat_ks'),
        mat_exponent=f32('mat_exponent'), mat_ks_weight=f32('mat_ks_weight'),
        mat_eta=f32('mat_eta'), mat_inv_eta=f32('mat_inv_eta'),
        mat_alpha=f32('mat_alpha'), mat_tex=t(mat_tex),
        tex_slots=tuple(bool(x) for x in (mat_tex >= 0).any(0)),
        mat_types=tuple(int(x) for x in np.unique(host['mat_type'])),
        light_type=i32('light_type'),
        light_types=tuple(int(x) for x in np.unique(host['light_type'])),
        light_weight=f32('light_weight'),
        light_cdf=f32('light_cdf'), light_pos=f32('light_pos'),
        light_emission=f32('light_emission'),
        light_tri=i32('light_tri'), light_tri_cdf=f32('light_tri_cdf'),
        light_ntri=i32('light_ntri'), light_inv_area=f32('light_inv_area'),
        env_image=f32('env_image'), env_neigh=f32('env_neigh'),
        env_rw2=f32('env_rw2'), env_cdf_rows=f32('env_cdf_rows'),
        env_cdf_cols=f32('env_cdf_cols'),
        env_row_weights=f32('env_row_weights'),
        env_normalization=float(np.float32(host['env_normalization'])),
        env_pixel_size=f32('env_pixel_size'),
        env_to_world_t=f32('env_to_world_t'),
        env_to_world_q=f32('env_to_world_q'),
        env_to_light_t=f32('env_to_light_t'),
        env_to_light_q=f32('env_to_light_q'),
        env_light_id=int(host['env_light_id']),
        bsphere_center=f32('bsphere_center'),
        bsphere_radius=float(radius),
        env_position_pdf=float(np.float32(1.0 / np.pi) / np.square(radius)),
        camera=cam, textures=texture_pack(host['textures'], device, dtype),
        has_motion=bool(host['has_motion']),
        num_tris=int(tri_p.shape[1]),
        num_lights=int(host['num_lights']), width=cam.width,
        height=cam.height, light_weight_sum=float(lw.sum()),
        device=device)
