"""Lights: point, mesh-area and lat-long environment emitters, batched and
differentiable (port of ops/lights.py).

One implementation per light type; every type the scene has is evaluated
on every lane and the lane's type selects. Conventions as in
the JAX package: direct_pdf is the pdf of SampleDirect in its native
measure (area for mesh lights, solid angle for the env map),
emission_pdf the pdf of emitting (position, direction). The env map maps
a direction d in light space to the image by (atan2(x, -z), acos(y)); its
CDF tables, neighbourhoods and row weights come from the host
(``scenedata.env_host_arrays``).
"""

import numpy as np
import torch

from ..utils import vecmath as vm
from ..utils.tree import select_by_type
from ..scene import transforms as T
from ..scene.scenedata import LIGHT_AREA, LIGHT_ENV, LIGHT_POINT


def pick_light(scene, u):
    """Sample a light by CDF. Returns (light_id int32, prob)."""
    idx = torch.searchsorted(scene.light_cdf, u.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, scene.num_lights - 1)
    prob = scene.light_weight[idx] / scene.light_weight_sum
    return idx.to(torch.int32), prob


def pick_light_prob(scene, light_id):
    return scene.light_weight[light_id.long()] / scene.light_weight_sum


def is_delta(scene, light_id):
    return scene.light_type[light_id.long()] == LIGHT_POINT


def is_finite(scene, light_id):
    return scene.light_type[light_id.long()] != LIGHT_ENV


def _searchsorted_rows(cdf2d, row, u):
    """Last index i with cdf2d[row, i] <= u, by bisection (one scalar
    gather per step instead of whole [lanes, K] rows)."""
    K = cdf2d.shape[-1]
    lo = torch.full_like(row, -1)
    hi = torch.full_like(row, K)
    for _ in range(int(np.ceil(np.log2(K + 1)))):
        active = hi - lo > 1
        mid = torch.div(lo + hi, 2, rounding_mode='floor')
        cm = cdf2d[row, torch.clamp(mid, 0, K - 1)]
        go = cm <= u
        lo = torch.where(active & go, mid, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def sample_discrete(scene, light_id, u):
    """Pick the area light's triangle by its area CDF; returns the global
    triangle id (int32), 0 for other lights."""
    lid = light_id.long()
    k = _searchsorted_rows(scene.light_tri_cdf, lid, u)
    k = torch.minimum(torch.clamp(k, min=0),
                      torch.clamp(scene.light_ntri[lid] - 1, min=0))
    return scene.light_tri[lid, k.long()]


def _sample_tri_from_row(row, u):
    """Uniform point on a triangle from its packed row; (pos, normal)."""
    a = torch.sqrt(torch.clamp((1.0 + vm.AD_EPS) - u[..., 0], min=0.0))
    b1 = 1.0 - a
    b2 = a * u[..., 1]
    pos = (row['p0'] + row['e1'] * b1[..., None]
           + row['e2'] * b2[..., None])
    w = 1.0 - b1 - b2
    tn = row['tn']
    normal = vm.normalize(w[..., None] * tn[..., 0, :]
                          + b1[..., None] * tn[..., 1, :]
                          + b2[..., None] * tn[..., 2, :])
    return pos, normal


def sample_tri(scene, tri_id, u, time):
    """Uniform point on triangle tri_id, at shutter `time`, for the sample
    parameters u [..., 2] (the sqrt warp of _sample_tri_from_row).
    Returns (pos, normal)."""
    from .intersect import gather_tri_row
    return _sample_tri_from_row(gather_tri_row(scene, tri_id.long(), time), u)


def get_sample_param(scene, tri_id, pos, time):
    """Inverse of sample_tri: the (u0, u1) that sample `pos` on triangle
    tri_id at `time`, through its barycentric coordinates."""
    from .intersect import gather_tri_row
    row = gather_tri_row(scene, tri_id.long(), time)
    e1, e2 = row['e1'], row['e2']
    e0 = pos - row['p0']
    d11 = vm.dot(e1, e1)
    d12 = vm.dot(e1, e2)
    d22 = vm.dot(e2, e2)
    d01 = vm.dot(e0, e1)
    d02 = vm.dot(e0, e2)
    inv_denom = 1.0 / vm.clamp_abs(d11 * d22 - d12 * d12)
    b1 = (d22 * d01 - d12 * d02) * inv_denom
    b2 = (d11 * d02 - d12 * d01) * inv_denom
    a = 1.0 - b1
    u0 = (1.0 + vm.AD_EPS) - a * a
    u1 = b2 / vm.clamp_abs(a)
    return torch.stack([u0, u1], -1)


def sample_tri_pdf(scene, tri_id):
    """The area-sampling pdf of the light that owns tri_id: 1 / its total
    area."""
    light = torch.clamp(scene.tri_light[tri_id.long()], min=0).long()
    return scene.light_inv_area[light]


# ---------------------------------------------------------------------------
# env map
# ---------------------------------------------------------------------------

def _env_uv_to_index(cdf, u):
    """CDF inversion of one shared cdf [K] at u [...]: (index, u' in the
    bin)."""
    idx = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[-1] - 2)
    lo = cdf[idx]
    hi = cdf[idx + 1]
    return idx, (u - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))


def _env_uv_to_index_rows(cdf2d, row, u):
    """CDF inversion over per-lane rows of a [H, K] table, by bisection:
    (index, u' in the bin)."""
    K = cdf2d.shape[-1]
    idx = torch.clamp(_searchsorted_rows(cdf2d, row, u), 0, K - 2)
    lo = cdf2d[row, idx]
    hi = cdf2d[row, idx + 1]
    return idx, (u - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))


def _env_bilinear_pack(scene, col, row):
    """The packed 2x2 texel neighbourhood (periodic wrap) and the clipped
    row weights of pixel (col, row): dict(v00, v10, v01, v11, rw0, rw1)."""
    h, w = scene.env_image.shape[0], scene.env_image.shape[1]
    nb = scene.env_neigh[torch.remainder(row, h).long(),
                         torch.remainder(col, w).long()]
    rw = scene.env_rw2[torch.clamp(row + 1, 0, h + 1).long()]
    return dict(v00=nb[..., 0:3], v10=nb[..., 3:6], v01=nb[..., 6:9],
                v11=nb[..., 9:12], rw0=rw[..., 0], rw1=rw[..., 1])


def bake_env_pixel(scene, lprim):
    """The constants of a frozen env pixel id: its cdf entries, texel
    neighbourhood and row weights. lprim may be an area-light triangle id
    on lanes of another light (the pack is masked by type where used), so
    it is clamped to the image."""
    h, w = scene.env_image.shape[0], scene.env_image.shape[1]
    lp = torch.clamp(lprim, 0, h * w - 1).long()
    row = torch.div(lp, w, rounding_mode='floor')
    col = lp - row * w
    return dict(row=row, col=col,
                cdf_row0=scene.env_cdf_rows[row],
                cdf_row1=scene.env_cdf_rows[row + 1],
                cdf_col0=scene.env_cdf_cols[row, col],
                cdf_col1=scene.env_cdf_cols[row, col + 1],
                **_env_bilinear_pack(scene, col, row))


def env_direction(scene, col, row, u0, u1, time, p):
    """Direction, value and solid-angle pdf of the tent-jittered point
    (u0, u1 in the bin) of env pixel (col, row), with p its
    _env_bilinear_pack. Returns (dir_world, value, pdf)."""
    tent = torch.stack([vm.tent(u0), vm.tent(u1)], -1)
    f = torch.get_default_dtype()
    pl = torch.stack([col.to(f), row.to(f)], -1) + tent
    phi = (pl[..., 0] + 0.5) * scene.env_pixel_size[0]
    theta = (pl[..., 1] + 0.5) * scene.env_pixel_size[1]
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
    sin_theta, cos_theta = torch.sin(theta), torch.cos(theta)
    d_light = torch.stack([sin_phi * sin_theta, cos_theta,
                           -cos_phi * sin_theta], -1)
    rot, _ = T.interpolate_rigid(scene.env_to_world_t, scene.env_to_world_q,
                                 time)
    d_world = T.rigid_xform_vector(rot, d_light)
    dx1 = tent[..., 0:1]
    dx2 = 1.0 - dx1
    dy1 = tent[..., 1:2]
    dy2 = 1.0 - dy1
    value1 = p['v00'] * dx2 * dy2 + p['v10'] * dx1 * dy2
    value2 = p['v01'] * dx2 * dy1 + p['v11'] * dx1 * dy1
    pdf = ((vm.luminance(value1) * p['rw0'] + vm.luminance(value2) * p['rw1'])
           * scene.env_normalization
           / torch.clamp(torch.abs(sin_theta), min=1e-7))
    return d_world, value1 + value2, pdf


def env_sample_direction(scene, rnd, time):
    """Importance-sample the env map: row by the row CDF, column by that
    row's CDF, then a tent jitter in the pixel. Returns (lprim_id = pixel
    id, dir_world, value, pdf)."""
    w = scene.env_image.shape[1]
    row, u1p = _env_uv_to_index(scene.env_cdf_rows, rnd[..., 1])
    col, u0p = _env_uv_to_index_rows(scene.env_cdf_cols, row, rnd[..., 0])
    d_world, value, pdf = env_direction(scene, col, row, u0p, u1p, time,
                                        _env_bilinear_pack(scene, col, row))
    return (row * w + col).to(torch.int32), d_world, value, pdf


def frozen_env_sample_direction(scene, pack, rnd, time):
    """env_sample_direction with the pixel frozen at pack
    (bake_env_pixel): the CDF inversion uses the pixel's stored cdf
    entries, so only the offsets within the pixel differentiate. Returns
    (dir_world, value, pdf)."""
    one = torch.ones_like(pack['cdf_col0'])
    u0 = (rnd[..., 0] - pack['cdf_col0']) / torch.where(
        pack['cdf_col1'] > pack['cdf_col0'],
        pack['cdf_col1'] - pack['cdf_col0'], one)
    u1 = (rnd[..., 1] - pack['cdf_row0']) / torch.where(
        pack['cdf_row1'] > pack['cdf_row0'],
        pack['cdf_row1'] - pack['cdf_row0'], one)
    return env_direction(scene, pack['col'], pack['row'], u0, u1, time, pack)


def _env_pixel_of(scene, dir_world, time):
    """Continuous pixel coordinates (uvx, uvy), the pixel (col, row) a
    world direction maps to and its light-space direction."""
    h, w = scene.env_image.shape[0], scene.env_image.shape[1]
    rot, _ = T.interpolate_rigid(scene.env_to_light_t, scene.env_to_light_q,
                                 time)
    d = T.rigid_xform_vector(rot, dir_world)
    uvx = torch.atan2(d[..., 0], -d[..., 2]) * vm.INV_TWO_PI * w - 0.5
    uvy = torch.acos(torch.clamp(d[..., 1], -1.0 + 1e-7, 1.0 - 1e-7)) \
        * vm.INV_PI * h - 0.5
    col = torch.floor(uvx).to(torch.int32)
    row = torch.floor(uvy).to(torch.int32)
    return uvx, uvy, col, row, d


def env_emission(scene, dir_world, time, pack=None):
    """Emission of rays escaping to the env map. Returns (lprim_id,
    emission, direct_pdf, emission_pdf).

    pack: optional bake_env_dir pack; the texel neighbourhood and row
    weights then come from it, so the discrete pixel stays frozen while
    the bilinear weights remain differentiable in dir_world."""
    h, w = scene.env_image.shape[0], scene.env_image.shape[1]
    uvx, uvy, col, row, d = _env_pixel_of(scene, dir_world, time)
    lprim = torch.remainder(row, h) * w + torch.remainder(col, w)
    dx1 = (uvx - col)[..., None]
    dx2 = 1.0 - dx1
    dy1 = (uvy - row)[..., None]
    dy2 = 1.0 - dy1
    p = pack if pack is not None else _env_bilinear_pack(scene, col, row)
    value1 = p['v00'] * dx2 * dy2 + p['v10'] * dx1 * dy2
    value2 = p['v01'] * dx2 * dy1 + p['v11'] * dx1 * dy1
    sin_theta = torch.sqrt(torch.clamp(1.0 - torch.square(d[..., 1]),
                                       min=1e-6))
    direct_pdf = ((vm.luminance(value1) * p['rw0']
                   + vm.luminance(value2) * p['rw1'])
                  * scene.env_normalization
                  / torch.clamp(torch.abs(sin_theta), min=1e-7))
    return (lprim, value1 + value2, direct_pdf,
            direct_pdf * scene.env_position_pdf)


def bake_env_dir(scene, dir_world, time):
    """env_emission's constants (texel neighbourhood, row weights) at the
    pixel a direction maps to; the bake pass runs it at the zero-offset
    direction."""
    _, _, col, row, _ = _env_pixel_of(scene, dir_world, time)
    return _env_bilinear_pack(scene, col, row)


def bake_light(scene, light_id, lprim_id):
    """Every per-lane constant emit/sample_direct need for a known
    (light, primitive), gathered once (the replay's light pack): the light
    row, the area light's triangle row and, with an env map, the frozen
    env pixel. Static scenes only: a moving area light's row depends on
    the lane's time."""
    from .intersect import gather_tri_row
    lid = torch.clamp(light_id, min=0).long()
    pack = dict(
        ltype=scene.light_type[lid],
        pos=scene.light_pos[lid],
        emission=scene.light_emission[lid],
        inv_area=scene.light_inv_area[lid],
        pick_prob=pick_light_prob(scene, lid),
        is_delta=scene.light_type[lid] == LIGHT_POINT,
        is_finite=scene.light_type[lid] != LIGHT_ENV,
        # lprim may be an env pixel id on env lanes: clamp to the tri table
        tri=gather_tri_row(scene, torch.clamp(lprim_id, 0,
                                              scene.num_tris - 1).long()))
    if scene.env_light_id >= 0:
        pack['env'] = bake_env_pixel(scene, lprim_id)
    return pack


def _light_consts(scene, light_id, lprim_id, pack, time):
    """(ltype, pos, emission, inv_area, tri row at `time`) from the pack
    or the scene tables."""
    if pack is not None:
        return (pack['ltype'], pack['pos'], pack['emission'],
                pack['inv_area'], pack['tri'])
    from .intersect import gather_tri_row
    lid = light_id.long()
    # lprim may be an env pixel id on env lanes: clamp to the tri table
    return (scene.light_type[lid], scene.light_pos[lid],
            scene.light_emission[lid], scene.light_inv_area[lid],
            gather_tri_row(scene, torch.clamp(lprim_id, 0,
                                              scene.num_tris - 1).long(),
                           time))


def sample_direct(scene, light_id, lprim_id, rnd, pos, time, pack=None,
                  skip_env=False):
    """Light::SampleDirect. lprim_id: the pre-picked area-light triangle;
    the env map picks its pixel from rnd. Each light type the scene has is
    evaluated on every lane and the lane's type selects.

    pack: optional bake_light pack (the replay). skip_env: zero the env
    branch (the frozen replay overrides it with the frozen-pixel form).

    Returns dict with dir_to_light, dist, contrib, cos_at_light,
    direct_pdf, emission_pdf, lprim_id, valid."""
    ltype, lpos, lemission, linv_area, tri_row = _light_consts(
        scene, light_id, lprim_id, pack, time)
    tri = torch.clamp(lprim_id, min=0)
    ones = torch.ones(pos.shape[:-1], device=pos.device)

    def point():
        to_l = lpos - pos
        dist_sq = torch.clamp(vm.length_squared(to_l), min=1e-12)
        dist = torch.sqrt(dist_sq)
        return dict(dir_to_light=to_l / dist[..., None], dist=dist,
                    contrib=lemission / dist_sq[..., None],
                    cos_at_light=ones, direct_pdf=dist_sq,
                    emission_pdf=torch.full_like(dist, vm.INV_FOUR_PI),
                    lprim_id=torch.zeros_like(tri),
                    valid=torch.ones_like(dist, dtype=torch.bool))

    def area():
        pos_l, n_l = _sample_tri_from_row(tri_row, rnd)
        shape_pdf = linv_area
        to_a = pos_l - pos
        dist_sq = torch.clamp(vm.length_squared(to_a), min=1e-12)
        dist = torch.sqrt(dist_sq)
        dir_a = to_a / dist[..., None]
        cos_a = -vm.dot(dir_a, n_l)
        safe_cos_a = torch.clamp(cos_a, min=vm.COS_EPS)
        # the clamp guards lanes of other lights, whose shape_pdf is 0
        contrib = (safe_cos_a / torch.clamp(dist_sq * shape_pdf, min=1e-12)
                   )[..., None] * lemission
        return dict(dir_to_light=dir_a, dist=dist, contrib=contrib,
                    cos_at_light=cos_a,
                    direct_pdf=shape_pdf * dist_sq / safe_cos_a,
                    emission_pdf=shape_pdf * safe_cos_a * vm.INV_PI,
                    lprim_id=tri, valid=cos_a > vm.COS_EPS)

    def env():
        if skip_env:
            lprim_e = torch.zeros_like(tri)
            dir_e = value_e = torch.zeros_like(pos)
            pdf_e = torch.zeros_like(ones)
        else:
            lprim_e, dir_e, value_e, pdf_e = env_sample_direction(scene, rnd,
                                                                  time)
        # sign-preserving clamp: the tent reconstruction can give matched
        # negative (value, pdf) pairs
        return dict(dir_to_light=dir_e, dist=torch.full_like(ones, np.inf),
                    contrib=value_e / vm.clamp_abs(pdf_e)[..., None],
                    cos_at_light=ones, direct_pdf=pdf_e,
                    emission_pdf=pdf_e * scene.env_position_pdf,
                    lprim_id=lprim_e.to(tri.dtype), valid=pdf_e > 0.0)

    fns = {LIGHT_POINT: point, LIGHT_AREA: area, LIGHT_ENV: env}
    return select_by_type(ltype, [(t, fns[t]()) for t in scene.light_types])


def area_emission(scene, light_id, dir_in, normal_on_light, pack=None):
    """AreaLight::Emission at a hit point. Returns (emission, direct_pdf,
    emission_pdf); pack: dict(emission, inv_area) of gathered constants."""
    if pack is not None:
        lem, linv = pack['emission'], pack['inv_area']
    else:
        lem = scene.light_emission[light_id.long()]
        linv = scene.light_inv_area[light_id.long()]
    cos_at = -vm.dot(normal_on_light, dir_in)
    ok = cos_at > 0.0
    em = torch.where(ok[..., None], lem, torch.zeros_like(lem))
    direct_pdf = torch.where(ok, linv, torch.zeros_like(linv))
    epdf = cos_at * linv * vm.INV_PI
    return em, direct_pdf, torch.where(ok, epdf, torch.zeros_like(epdf))


def env_emit_ray(scene, d_sample, rnd_pos):
    """The env map's emission ray for the sampled direction d_sample: it
    starts on the disc of the x1000 bounding sphere facing -d_sample.
    Returns (org, dir)."""
    d_e = -d_sample
    offset = vm.sample_concentric_disc(rnd_pos)
    b0, b1 = vm.coordinate_system(d_e)
    perp = offset[..., 0:1] * b0 + offset[..., 1:2] * b1
    return scene.bsphere_center + (perp - d_e) * scene.bsphere_radius, d_e


def emit(scene, light_id, lprim_id, rnd_pos, rnd_dir, time, pack=None,
         skip_env=False):
    """Light::Emit: the light subpath's first ray, each light type the
    scene has evaluated on every lane and the lane's type selecting.

    pack / skip_env: see sample_direct. For area lights lprim_id is the
    pre-picked global triangle id; the env map picks its pixel from
    rnd_dir.

    Returns dict with org, dir, emission, cos_at_light, emission_pdf,
    direct_pdf, lprim_id."""
    ltype, lpos, lemission, linv_area, tri_row = _light_consts(
        scene, light_id, lprim_id, pack, time)
    tri = torch.clamp(lprim_id, min=0)
    ones = torch.ones(rnd_dir.shape[:-1], device=rnd_dir.device)

    def point():
        d_p, _ = vm.sample_sphere(rnd_dir)
        return dict(org=torch.broadcast_to(lpos, d_p.shape), dir=d_p,
                    emission=torch.broadcast_to(lemission, d_p.shape),
                    cos_at_light=ones,
                    emission_pdf=torch.full_like(ones, vm.INV_FOUR_PI),
                    direct_pdf=ones, lprim_id=torch.zeros_like(tri))

    def area():
        pos_a, n_a = _sample_tri_from_row(tri_row, rnd_pos)
        shape_pdf = linv_area
        local = vm.sample_cos_hemisphere(rnd_dir)
        cos_a = local[..., 2]
        return dict(org=pos_a, dir=vm.local_to_world(local, n_a),
                    emission=lemission * (vm.PI / torch.clamp(
                        shape_pdf, min=1e-12))[..., None],
                    cos_at_light=cos_a,
                    emission_pdf=cos_a * vm.INV_PI * shape_pdf,
                    direct_pdf=torch.broadcast_to(shape_pdf, cos_a.shape),
                    lprim_id=tri)

    def env():
        if skip_env:
            lprim_e = torch.zeros_like(tri)
            d_sample = em_e = torch.zeros(rnd_dir.shape[:-1] + (3,),
                                          device=rnd_dir.device)
            dpdf_e = torch.zeros_like(ones)
        else:
            lprim_e, d_sample, em_e, dpdf_e = env_sample_direction(
                scene, rnd_dir, time)
        org_e, d_e = env_emit_ray(scene, d_sample, rnd_pos)
        return dict(org=org_e, dir=d_e, emission=em_e, cos_at_light=ones,
                    emission_pdf=dpdf_e * scene.env_position_pdf,
                    direct_pdf=dpdf_e, lprim_id=lprim_e.to(tri.dtype))

    fns = {LIGHT_POINT: point, LIGHT_AREA: area, LIGHT_ENV: env}
    return select_by_type(ltype, [(t, fns[t]()) for t in scene.light_types])
