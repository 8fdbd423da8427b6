"""Wavefront path generation (port of path/trace.py).

A wavefront of paths advances together through Python loops over the
padded depth with per-lane alive masks; every random decision reads a
pre-drawn uniform tape, so the same function serves bootstrap sampling,
plain MC rendering and MCMC large steps. MIS bookkeeping follows the
recursive accMISWPrev / accMISWThis scheme of the JAX package.

Point, area and environment lights, every BSDF of the scene package,
light-coordinate sampling. A camera ray that escapes hits the env map
(when the scene has one); an env light's emission rays start on the disc
of the x1000 bounding sphere. generate_path_bidir gives every (s, t)
technique of a path; generate_subpath one chosen technique per lane (the
multiplexed large steps).
"""

import dataclasses

import torch

from ..utils import vecmath as vm
from ..utils.tree import tree_map, tree_where
from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops.intersect import make_intersect_fns, hit_attrs_full
from ..scene.camera import sample_primary, project_point, camera_center_dir
from .records import Contribs, empty_record, empty_contribs, to_subpath

MIS = vm.mis
INF = float('inf')
ACC_MAX = 1e30  # keeps the power-2 MIS accumulators finite in f32


# ---------------------------------------------------------------------------
# random tape
# ---------------------------------------------------------------------------

class Tape:
    """Index map into a [C, 9 + 12*D] uniform tape."""

    def __init__(self, u, D):
        self.u = u
        self.D = D

    @staticmethod
    def size(D):
        return 9 + 12 * D

    @property
    def time(self):
        return self.u[:, 0]

    @property
    def light_pick(self):
        return self.u[:, 1]

    @property
    def light_disc(self):
        return self.u[:, 2]

    @property
    def light_pos(self):
        return self.u[:, 3:5]

    @property
    def light_dir(self):
        return self.u[:, 5:7]

    @property
    def screen(self):
        return self.u[:, 7:9]

    def lgt_vertex(self, i):
        b = 9 + 4 * i
        return dict(disc=self.u[:, b], bsdf=self.u[:, b + 1:b + 3],
                    rr=self.u[:, b + 3])

    def cam_vertex(self, i):
        b = 9 + 4 * self.D + 8 * i
        return dict(disc=self.u[:, b], nee_pick=self.u[:, b + 1],
                    nee_disc=self.u[:, b + 2], nee_rnd=self.u[:, b + 3:b + 5],
                    bsdf=self.u[:, b + 5:b + 7], rr=self.u[:, b + 7])


def draw_tape(generator, C, D, device):
    """A [C, tape size] uniform tape drawn from `generator`."""
    return Tape(torch.rand((C, Tape.size(D)), generator=generator,
                           device=device), D)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def shading_normal_correction(wi, shading_n, geom_n, wo, adjoint):
    """Light-leak guard + adjoint shading-normal factor."""
    cos_wi = vm.dot(shading_n, wi)
    cos_wo = vm.dot(shading_n, wo)
    wi_geo = vm.dot(geom_n, wi)
    wo_geo = vm.dot(geom_n, wo)
    leak = (wi_geo * cos_wi <= 0.0) | (wo_geo * cos_wo <= 0.0)
    if adjoint:
        den = wi_geo * cos_wo
        safe = torch.where(den == 0.0, torch.ones_like(den), den)
        factor = torch.abs((wo_geo * cos_wi) / safe)
    else:
        factor = torch.ones_like(cos_wi)
    return torch.where(leak, torch.zeros_like(factor), factor)


def screen_pixel_count(scene):
    return float(scene.width * scene.height)


def camera_pdf_w(scene, cam_dir_center, d):
    """imageToSolidAngleFactor of a primary direction d."""
    cos_at_cam = vm.dot(cam_dir_center, d)
    dist = scene.camera.dist / cos_at_cam
    return torch.square(dist) / cos_at_cam


def russian_roulette_prob(depth, contrib):
    """rrProb = depth >= 3 ? min(maxCoeff(contrib), 0.95) : 1."""
    if depth >= 3:
        return torch.clamp(torch.amax(contrib, -1), max=0.95)
    return torch.ones(contrib.shape[:-1], device=contrib.device)


@dataclasses.dataclass
class SurfState:
    """Per-wavefront surface interaction."""
    pos: torch.Tensor
    shading_n: torch.Tensor
    geom_n: torch.Tensor
    st: torch.Tensor
    wi: torch.Tensor
    mat: bsdf_ops.MatParams
    tri: torch.Tensor
    acc_prev: torch.Tensor
    acc_this: torch.Tensor
    throughput: torch.Tensor
    ss_jacobian: torch.Tensor


def convert_mis(state, ray_org, ray_dir, include_dist):
    dist_sq = vm.distance_squared(ray_org, state.pos)
    acc_prev = torch.where(include_dist, state.acc_prev * MIS(dist_sq),
                           state.acc_prev)
    inv_cos = 1.0 / torch.clamp(
        MIS(torch.abs(vm.dot(ray_dir, state.shading_n))), min=1e-12)
    return dataclasses.replace(
        state, acc_prev=torch.clamp(acc_prev * inv_cos, max=ACC_MAX),
        acc_this=torch.clamp(state.acc_this * inv_cos, max=ACC_MAX))


def bsdf_sampling(scene, opts, state, bsdf_rnd, bsdf_disc, depth, adjoint,
                  perturb=False, use_abs_in=None):
    """BSDF sampling at a vertex.

    Returns (new_dir, new_state, contrib, use_abs, valid, rnd_canonical,
    pdf, lc_jac): in absolute-parameter mode the recorded random numbers
    are the spherical coordinates of the sampled direction, and perturb
    replay re-derives the direction from them. lc_jac is the sampling
    density of the recorded parameters (1 / the spherical Jacobian in
    absolute mode, else the BSDF pdf): light-coordinate sampling divides
    it out of the next vertex's ssJacobian."""
    use_abs = bsdf_ops.roughness(state.mat) > opts.roughness_threshold
    if perturb:
        use_abs = use_abs_in
    wo_s, contrib_s, cos_wo_s, pdf_s, rev_pdf_s, valid_s = bsdf_ops.sample(
        state.mat, state.wi, state.shading_n, bsdf_rnd, bsdf_disc, adjoint)
    sph_s, jac_sph = vm.to_spherical_coord(wo_s)
    ua = use_abs[..., None]
    one = torch.ones_like(pdf_s)

    if perturb:
        wo_a, jac_a = vm.sample_sphere(bsdf_rnd)
        c_a, cw_a, p_a, rp_a = bsdf_ops.evaluate(
            state.mat, state.wi, state.shading_n, wo_a, adjoint)
        valid_a = (torch.amax(torch.abs(c_a), -1) > 0.0) & (p_a > 0.0)
        c_a = c_a / torch.clamp(p_a, min=1e-12)[..., None]
        wo = torch.where(ua, wo_a, wo_s)
        contrib = torch.where(ua, c_a, contrib_s)
        cos_wo = torch.where(use_abs, cw_a, cos_wo_s)
        pdf = torch.where(use_abs, p_a, pdf_s)
        rev_pdf = torch.where(use_abs, rp_a, rev_pdf_s)
        valid = torch.where(use_abs, valid_a, valid_s)
        ss_fac = torch.where(use_abs, jac_a * p_a, one)
        lc_jac = torch.where(use_abs, 1.0 / torch.clamp(jac_a, min=1e-12),
                             pdf_s)
        rnd_canonical = bsdf_rnd
    else:
        wo, contrib, cos_wo, pdf, rev_pdf, valid = (
            wo_s, contrib_s, cos_wo_s, pdf_s, rev_pdf_s, valid_s)
        ss_fac = torch.where(use_abs, jac_sph * pdf_s, one)
        lc_jac = torch.where(use_abs, 1.0 / torch.clamp(jac_sph, min=1e-12),
                             pdf_s)
        rnd_canonical = torch.where(ua, sph_s, bsdf_rnd)

    factor = shading_normal_correction(state.wi, state.shading_n,
                                       state.geom_n, wo, adjoint)
    valid = valid & (factor > 0.0)
    contrib = contrib * factor[..., None]
    new_state = dataclasses.replace(
        state,
        acc_this=torch.clamp(MIS(cos_wo / vm.clamp_abs(pdf))
                             * (state.acc_this * MIS(rev_pdf)
                                + state.acc_prev), max=ACC_MAX),
        acc_prev=torch.clamp(MIS(1.0 / vm.clamp_abs(pdf)), max=ACC_MAX),
        throughput=state.throughput * contrib,
        ss_jacobian=state.ss_jacobian * ss_fac)
    return wo, new_state, contrib, use_abs, valid, rnd_canonical, pdf, lc_jac


# ---------------------------------------------------------------------------
# contribution emitters
# ---------------------------------------------------------------------------

def handle_hit_light(scene, first_vertex, hit_surface, hit_light_id, ray_dir,
                     time, state, pack=None, bidir_mis=True, ray_org=None,
                     last_bsdf_pdf=None):
    """Emission where the camera subpath hits an area light or escapes to
    the env map, with bidir MIS (weight 1 for a directly visible light).
    pack: dict(emission, inv_area, pick_prob[, env: bake_env_dir pack]) of
    gathered constants. bidir_mis=False: the unidirectional power-2
    balance against the pdf of the BSDF sampling that shot the ray
    (generate_subpath with bidirectional=false); needs ray_org and
    last_bsdf_pdf.
    Returns (contrib, ls, ss, mis_w, valid)."""
    lid = torch.clamp(hit_light_id, min=0)
    em, direct_pdf, emission_pdf = light_ops.area_emission(
        scene, lid, ray_dir, state.shading_n, pack=pack)
    pick = pack['pick_prob'] if pack is not None \
        else light_ops.pick_light_prob(scene, lid)
    if scene.env_light_id >= 0:
        is_env = ~hit_surface
        _, em_e, dpdf_e, epdf_e = light_ops.env_emission(
            scene, ray_dir, time, pack=None if pack is None else pack['env'])
        em = torch.where(is_env[..., None], em_e, em)
        direct_pdf = torch.where(is_env, dpdf_e, direct_pdf)
        emission_pdf = torch.where(is_env, epdf_e, emission_pdf)
        env_pick = light_ops.pick_light_prob(
            scene, torch.full_like(lid, scene.env_light_id))
        pick = torch.where(is_env, env_pick, pick)
    else:
        em = torch.where(hit_surface[..., None], em, torch.zeros_like(em))
    valid = torch.sum(em, -1) > 0.0
    contrib = state.throughput * em
    direct_pdf = direct_pdf * pick
    emission_pdf = emission_pdf * pick
    if bidir_mis:
        w_camera = (MIS(direct_pdf) * state.acc_prev
                    + MIS(emission_pdf) * state.acc_this)
        mis_w = 1.0 / (1.0 + w_camera)
    else:
        # area pdf -> solid angle for surface hits
        dist_sq = vm.distance_squared(ray_org, state.pos)
        cos_theta = -vm.dot(ray_dir, state.shading_n)
        dpdf_sa = torch.where(hit_surface,
                              direct_pdf * dist_sq / vm.clamp_abs(cos_theta),
                              direct_pdf)
        mis_w = 1.0 / (1.0 + torch.square(dpdf_sa
                                          / vm.clamp_abs(last_bsdf_pdf)))
    mis_w = torch.where(first_vertex, torch.ones_like(mis_w), mis_w)
    contrib = contrib * mis_w[..., None]
    score = vm.luminance(contrib)
    valid = valid & (score > 0.0)
    return contrib, score, score * state.ss_jacobian, mis_w, valid


def direct_lighting(scene, opts, occluded_fn, state, time, light_id, lprim,
                    nee_rnd, light_pick_prob, bidir_mis=True):
    """Next-event estimation with bidir MIS; bidir_mis=False: the
    unidirectional power-2 balance against the BSDF pdf.
    Returns (contrib, score, ss_score, mis_w, valid, lprim_id)."""
    out = light_ops.sample_direct(scene, light_id, lprim, nee_rnd,
                                  state.pos, time)
    valid = out['valid']
    occ = occluded_fn(state.pos, out['dir_to_light'], time,
                      torch.full_like(time, vm.ISECT_EPS),
                      (1.0 - vm.SHADOW_EPS) * out['dist'])
    valid = valid & ~occ
    b_contrib, cos_to_light, bsdf_pdf, bsdf_rev_pdf = bsdf_ops.evaluate(
        state.mat, state.wi, state.shading_n, out['dir_to_light'])
    valid = valid & (torch.amax(torch.abs(b_contrib), -1) > 0.0)
    factor = shading_normal_correction(state.wi, state.shading_n,
                                       state.geom_n, out['dir_to_light'],
                                       False)
    valid = valid & (factor > 0.0)
    b_contrib = b_contrib * factor[..., None]
    contrib = (state.throughput * b_contrib * out['contrib']
               / torch.clamp(light_pick_prob, min=1e-12)[..., None])
    if bidir_mis:
        mis_w = _nee_mis(scene, light_id, out, light_pick_prob, bsdf_pdf,
                         bsdf_rev_pdf, cos_to_light, state)
    else:
        mis_w = 1.0 / (1.0 + torch.square(bsdf_pdf / vm.clamp_abs(
            out['direct_pdf'] * light_pick_prob)))
        mis_w = torch.where(light_ops.is_delta(scene, light_id),
                            torch.ones_like(mis_w), mis_w)
    contrib = contrib * mis_w[..., None]
    score = vm.luminance(contrib)
    valid = valid & (score > 0.0)
    return (contrib, score, score * state.ss_jacobian, mis_w, valid,
            out['lprim_id'])


def _nee_mis(scene, light_id, out, light_pick_prob, bsdf_pdf, bsdf_rev_pdf,
             cos_to_light, state):
    delta = light_ops.is_delta(scene, light_id)
    safe_dpdf = vm.clamp_abs(out['direct_pdf'])
    w_light = MIS(bsdf_pdf / (light_pick_prob * safe_dpdf))
    w_light = torch.where(delta, torch.zeros_like(w_light), w_light)
    safe_cal = vm.clamp_abs(out['cos_at_light'])
    w_camera = (MIS(out['emission_pdf'] * cos_to_light
                    / (safe_dpdf * safe_cal))
                * (state.acc_prev + state.acc_this * MIS(bsdf_rev_pdf)))
    return 1.0 / (w_light + 1.0 + w_camera)


def connect_vertex(scene, opts, occluded_fn, time, lgt_state, cam_state,
                   do_occlusion=True, mask=None, occ_in=None):
    """Connect a light vertex and a camera vertex.
    Returns (contrib, ls, ss, mis, valid).

    mask: lanes outside it shoot dead occlusion rays (max_t = 0).
    occ_in: precomputed occlusion of this connection's ray."""
    to_light = lgt_state.pos - cam_state.pos
    dist_sq = torch.clamp(vm.length_squared(to_light), min=1e-12)
    dist = torch.sqrt(dist_sq)
    dir_tl = to_light / dist[..., None]
    valid = torch.ones(dist.shape, dtype=torch.bool, device=dist.device)
    if occ_in is not None:
        valid = valid & ~occ_in
    elif do_occlusion:
        occ_max = (1.0 - vm.SHADOW_EPS) * dist
        if mask is not None:
            occ_max = torch.where(mask, occ_max, torch.zeros_like(occ_max))
        occ = occluded_fn(cam_state.pos, dir_tl, time,
                          torch.full_like(time, vm.ISECT_EPS), occ_max)
        valid = valid & ~occ

    cam_f, cos_cam, cam_pdf, cam_rev_pdf = bsdf_ops.evaluate(
        cam_state.mat, cam_state.wi, cam_state.shading_n, dir_tl)
    valid = valid & (torch.amax(torch.abs(cam_f), -1) > 0.0)
    cam_factor = shading_normal_correction(
        cam_state.wi, cam_state.shading_n, cam_state.geom_n, dir_tl, False)
    valid = valid & (cam_factor > 0.0)
    cam_f = cam_f * cam_factor[..., None]

    lgt_f, cos_lgt, lgt_pdf, lgt_rev_pdf = bsdf_ops.evaluate(
        lgt_state.mat, lgt_state.wi, lgt_state.shading_n, -dir_tl,
        adjoint=True)
    valid = valid & (torch.amax(torch.abs(lgt_f), -1) > 0.0)
    lgt_factor = shading_normal_correction(
        lgt_state.wi, lgt_state.shading_n, lgt_state.geom_n, -dir_tl, True)
    valid = valid & (lgt_factor > 0.0)
    lgt_f = lgt_f * lgt_factor[..., None]

    geom = 1.0 / dist_sq
    cam_dir_pdf_a = cam_pdf * cos_lgt * geom
    lgt_dir_pdf_a = lgt_pdf * cos_cam * geom
    w_light = MIS(cam_dir_pdf_a) * (lgt_state.acc_prev
                                    + lgt_state.acc_this * MIS(lgt_rev_pdf))
    w_camera = MIS(lgt_dir_pdf_a) * (cam_state.acc_prev
                                     + cam_state.acc_this * MIS(cam_rev_pdf))
    mis_w = 1.0 / (w_light + 1.0 + w_camera)
    contrib = (lgt_state.throughput * cam_state.throughput * cam_f * lgt_f
               * geom[..., None] * mis_w[..., None])
    score = vm.luminance(contrib)
    valid = valid & (score > 0.0)
    ss = score * lgt_state.ss_jacobian * cam_state.ss_jacobian
    return contrib, score, ss, mis_w, valid


def connect_to_camera(scene, opts, occluded_fn, time, state, screen_pc,
                      do_occlusion=True, mask=None, occ_in=None):
    """Connect a light vertex to the camera.
    Returns (screen_pos, contrib, ls, ss, mis, valid)."""
    cam_org, cam_dir = camera_center_dir(scene.camera, time)
    to_cam = cam_org - state.pos
    valid = -vm.dot(cam_dir, to_cam) > 0.0
    screen_pos, proj_ok = project_point(scene.camera, state.pos, time)
    valid = valid & proj_ok
    dist_sq = torch.clamp(vm.length_squared(to_cam), min=1e-12)
    dist = torch.sqrt(dist_sq)
    dir_tc = to_cam / dist[..., None]
    if occ_in is not None:
        valid = valid & ~occ_in
    elif do_occlusion:
        occ_max = (1.0 - vm.SHADOW_EPS) * dist
        if mask is not None:
            occ_max = torch.where(mask, occ_max, torch.zeros_like(occ_max))
        occ = occluded_fn(state.pos, dir_tc, time,
                          torch.full_like(time, vm.ISECT_EPS), occ_max)
        valid = valid & ~occ
    b_contrib, cos_to_cam, bsdf_pdf, bsdf_rev_pdf = bsdf_ops.evaluate(
        state.mat, state.wi, state.shading_n, dir_tc, adjoint=True)
    valid = valid & (torch.amax(torch.abs(b_contrib), -1) > 0.0)
    factor = shading_normal_correction(state.wi, state.shading_n,
                                       state.geom_n, dir_tc, True)
    valid = valid & (factor > 0.0)
    b_contrib = b_contrib * factor[..., None]

    cos_at_cam = -vm.dot(cam_dir, dir_tc)
    ipcd = scene.camera.dist / cos_at_cam
    image_to_solid_angle = torch.square(ipcd) / cos_at_cam
    image_to_surface = image_to_solid_angle * torch.abs(cos_to_cam) / dist_sq
    cam_pdf = image_to_surface
    w_light = MIS(cam_pdf / screen_pc) * (state.acc_prev
                                          + state.acc_this * MIS(bsdf_rev_pdf))
    mis_w = 1.0 / (w_light + 1.0)
    # surfaceToImageFactor = cosToCamera / imageToSurface
    surface_to_image = cos_to_cam / vm.clamp_abs(image_to_surface)
    safe_sti = vm.clamp_abs(surface_to_image)
    contrib = (mis_w[..., None] * b_contrib / (screen_pc * safe_sti[..., None])
               * state.throughput)
    score = vm.luminance(contrib)
    valid = valid & (score > 0.0)
    return screen_pos, contrib, score, score * state.ss_jacobian, mis_w, valid


def _masked(ok, x):
    m = ok.reshape(ok.shape + (1,) * (x.ndim - ok.ndim))
    return torch.where(m, x, torch.zeros_like(x))


def _surf(scene, org, d, hit_out, time, acc_prev, acc_this, throughput,
          ss_jac, tri):
    hit, tid, t_hit, u_hit, v_hit = hit_out
    pos, sn, gn, st, mat_id, light_id = hit_attrs_full(
        scene, tid.long(), org, d, t_hit, u_hit, v_hit, time)
    mat = bsdf_ops.gather_mat_params(scene, mat_id, st)
    return SurfState(pos=pos, shading_n=sn, geom_n=gn, st=st, wi=-d, mat=mat,
                     tri=tri, acc_prev=acc_prev, acc_this=acc_this,
                     throughput=throughput, ss_jacobian=ss_jac), light_id


# ---------------------------------------------------------------------------
# light-coordinate sampling
# ---------------------------------------------------------------------------

def _light_coords(scene, opts, c, h_ok, hit, hit_light_id, tid, state, org,
                  time, lc_jac_prev, h_ss):
    """Light-coordinate reparameterisation of an (s, 0) technique whose
    camera vertex c (c > 1) hits an area light: the previous vertex's BSDF
    parameters become the light triangle's sample parameters of the hit
    point, and ssJacobian changes measure by |cos| / dist^2 * lcJacobian /
    SamplePdf(). (lcJacobian / SamplePdf() is the convention the replay
    reproduces; it is mirrored as the JAX package has it.)
    Returns (lc_ok [C], lc_param [C, 2], h_ss)."""
    C = h_ok.shape[0]
    if not opts.use_light_coordinate_sampling or c <= 1:
        return (torch.zeros_like(h_ok),
                torch.zeros((C, 2), device=h_ok.device), h_ss)
    lc_ok = h_ok & hit & (hit_light_id >= 0)
    tri = torch.clamp(tid, min=0)
    lc_param = light_ops.get_sample_param(scene, tri, state.pos, time)
    to_prev = state.pos - org
    d2 = torch.clamp(vm.length_squared(to_prev), min=1e-12)
    to_prev = to_prev / torch.sqrt(d2)[..., None]
    lc_factor = (torch.abs(vm.dot(to_prev, state.shading_n) / d2)
                 * lc_jac_prev / light_ops.sample_tri_pdf(scene, tri))
    return lc_ok, lc_param, torch.where(lc_ok, h_ss * lc_factor, h_ss)


def _shift_light_coords(opts, cam_bsdf_rnd, lc_ok, lc_param):
    """Write the light-coordinate parameters found at camera vertex c into
    the BSDF parameters of vertex c - 1. All [C, D(, 2)]."""
    if not opts.use_light_coordinate_sampling:
        return cam_bsdf_rnd
    shift_ok = torch.zeros_like(lc_ok)
    shift_ok[:, :-1] = lc_ok[:, 1:]
    shift_param = torch.zeros_like(lc_param)
    shift_param[:, :-1] = lc_param[:, 1:]
    return torch.where(shift_ok[..., None], shift_param, cam_bsdf_rnd)


# ---------------------------------------------------------------------------
# bidirectional generation
# ---------------------------------------------------------------------------

def _light_start(scene, tape, rec):
    time = tape.time
    light_id, light_pick_prob = light_ops.pick_light(scene, tape.light_pick)
    lgt_lprim = light_ops.sample_discrete(scene, light_id, tape.light_disc)
    em = light_ops.emit(scene, light_id, lgt_lprim, tape.light_pos,
                        tape.light_dir, time)
    emission_pdf = em['emission_pdf'] * light_pick_prob
    direct_pdf = em['direct_pdf'] * light_pick_prob
    throughput0 = em['emission'] / torch.clamp(light_pick_prob,
                                               min=1e-12)[..., None]
    delta_light = light_ops.is_delta(scene, light_id)
    finite_light = light_ops.is_finite(scene, light_id)
    safe_epdf = vm.clamp_abs(emission_pdf)
    acc_prev0 = MIS(direct_pdf / safe_epdf)
    acc_this0 = MIS(em['cos_at_light'] / safe_epdf)
    acc_this0 = torch.where(delta_light, torch.zeros_like(acc_this0),
                            acc_this0)
    rec = dataclasses.replace(
        rec, lgt_light_id=light_id, lgt_lprim=em['lprim_id'].to(torch.int32),
        lgt_rnd_pos=tape.light_pos, lgt_rnd_dir=tape.light_dir)
    return em, emission_pdf, throughput0, finite_light, acc_prev0, \
        acc_this0, rec


def generate_path_bidir(scene, opts, tape: Tape, pixel=None, min_depth=None,
                        max_depth=None):
    """Generate a wavefront of bidirectional paths from a uniform tape.

    pixel: optional [C,2] int pixel coords restricting screen sampling.
    Returns (PathRecord, Contribs, lgt_alive [C,D], cam_alive [C,D])."""
    D = opts.max_depth
    min_depth = opts.min_depth if min_depth is None else min_depth
    max_depth = opts.max_depth if max_depth is None else max_depth
    md = 0 if min_depth == -1 else min_depth
    mx = D + 2 if max_depth == -1 else max_depth
    C = tape.u.shape[0]
    dev = tape.u.device
    intersect_fn, occluded_fn = make_intersect_fns(scene)
    spc = screen_pixel_count(scene)
    ones_b = torch.ones(C, dtype=torch.bool, device=dev)
    eps = torch.full((C,), vm.ISECT_EPS, device=dev)
    inf = torch.full((C,), INF, device=dev)

    time = tape.time
    rec = dataclasses.replace(empty_record(C, D, dev), time=time)

    # ---- light subpath ----
    em, emission_pdf, throughput, finite_light, acc_prev, acc_this, rec = \
        _light_start(scene, tape, rec)
    org, d, alive = em['org'], em['dir'], emission_pdf > 0.0
    ss_jac = torch.ones(C, device=dev)
    lgt = []
    for l in range(D):
        vdata = tape.lgt_vertex(l)
        hit_out = intersect_fn(org, d, time, eps, inf)
        hit, tid = hit_out[0], hit_out[1]
        exists = alive & hit
        tri = torch.where(exists, tid, torch.full_like(tid, -1))
        state, _ = _surf(scene, org, d, hit_out, time, acc_prev, acc_this,
                         throughput, ss_jac, tri)
        state = convert_mis(state, org, d, finite_light if l == 0 else ones_b)

        # connect to camera -> slot (1, 2+l), only up to lgtDepth+2 == maxDepth
        cc_screen, cc_contrib, cc_ls, cc_ss, cc_mis, cc_ok = \
            connect_to_camera(scene, opts, occluded_fn, time, state, spc)
        cc_ok = cc_ok & exists & (l + 2 >= md) & (l + 2 <= mx)

        new_d, new_state, b_contrib, use_abs, b_ok, rnd_canon, _, _ = \
            bsdf_sampling(scene, opts, state, vdata['bsdf'], vdata['disc'], l,
                          adjoint=True)
        rr_prob = russian_roulette_prob(l, b_contrib)
        rr_ok = vdata['rr'] <= rr_prob
        rr_weight = 1.0 / torch.clamp(rr_prob, min=1e-12)
        alive = exists & b_ok & rr_ok & (l + 2 < mx)
        lgt.append(dict(
            exists=exists, tri=tri, disc=vdata['disc'], rnd_canon=rnd_canon,
            use_abs=use_abs,
            rr_weight=torch.where(rr_ok, rr_weight, torch.ones_like(rr_weight)),
            cc_screen=_masked(cc_ok, cc_screen),
            cc_contrib=_masked(cc_ok, cc_contrib),
            cc_ls=_masked(cc_ok, cc_ls), cc_ss=_masked(cc_ok, cc_ss),
            cc_mis=_masked(cc_ok, cc_mis), state=state))
        org, d = state.pos, new_d
        acc_prev, acc_this = new_state.acc_prev, new_state.acc_this
        throughput = new_state.throughput * rr_weight[..., None]
        ss_jac = new_state.ss_jacobian

    stackl = lambda k: torch.stack([y[k] for y in lgt], 1)
    lgt_alive = stackl('exists')
    rec = dataclasses.replace(
        rec, lgt_tri=stackl('tri'), lgt_bsdf_rnd=stackl('rnd_canon'),
        lgt_bsdf_disc=stackl('disc'), lgt_use_abs=stackl('use_abs'),
        lgt_rr=stackl('rr_weight'))

    # all D light states stacked [D*C] for the flattened vertex connections
    lgt_flat = tree_map(lambda *xs: torch.cat(xs, 0),
                        *[y['state'] for y in lgt])
    lgt_exists_flat = torch.cat([y['exists'] for y in lgt], 0)
    time_flat = time.repeat(D)

    # ---- camera subpath ----
    if pixel is None:
        screen = tape.screen
    else:
        f = torch.get_default_dtype()
        screen = (pixel.to(f) + tape.screen) / torch.tensor(
            [scene.width, scene.height], dtype=f, device=dev)
    rec = dataclasses.replace(rec, screen_pos=screen)
    org, d, min_t, max_t = sample_primary(scene.camera, screen, time)
    _, cam_center = camera_center_dir(scene.camera, time)
    cam_pdf_w0 = camera_pdf_w(scene, cam_center, d)
    alive = ones_b
    has_env = scene.env_light_id >= 0
    env_lprim = torch.full((C,), -1, dtype=torch.int32, device=dev)
    acc_prev = MIS(spc / cam_pdf_w0)
    acc_this = torch.zeros(C, device=dev)
    throughput = torch.ones((C, 3), device=dev)
    ss_jac = torch.ones(C, device=dev)
    lc_jac_prev = torch.ones(C, device=dev)
    l_len = torch.arange(D, device=dev).repeat_interleave(C)
    cam = []
    for c in range(D):
        vdata = tape.cam_vertex(c)
        hit_out = intersect_fn(org, d, time, min_t, max_t)
        hit, tid = hit_out[0], hit_out[1]
        state, light_id = _surf(scene, org, d, hit_out, time, acc_prev,
                                acc_this, throughput, ss_jac, tid)
        state_mis = convert_mis(state, org, d, ones_b)
        state = dataclasses.replace(
            state, acc_prev=torch.where(hit, state_mis.acc_prev,
                                        state.acc_prev),
            acc_this=torch.where(hit, state_mis.acc_this, state.acc_this))

        hit_light_id = torch.where(hit, light_id, torch.full_like(light_id, -1))
        is_env_hit = ~hit & alive & has_env
        hit_light = alive & ((hit & (hit_light_id >= 0)) | is_env_hit)
        exists = alive & hit

        # hit light -> slot (2+c, 0); terminates the path
        h_contrib, h_ls, h_ss, h_mis, h_ok = handle_hit_light(
            scene, torch.full((C,), c == 0, device=dev), hit, hit_light_id, d,
            time, state)
        h_ok = h_ok & hit_light & (c + 1 >= md)
        lc_ok, lc_param, h_ss = _light_coords(scene, opts, c, h_ok, hit,
                                              hit_light_id, tid, state, org,
                                              time, lc_jac_prev, h_ss)
        if has_env:
            # the env pixel of the path's env hit, frozen for the replay
            env_pix = light_ops.env_emission(scene, d, time)[0]
            env_lprim = torch.where(is_env_hit & h_ok, env_pix, env_lprim)
        if c + 1 >= md:
            alive = alive & ~hit_light
        cam_alive_now = exists & alive
        alive = alive & hit & (c + 1 < mx)

        # NEE -> slot (2+c, 1)
        nee_light, nee_prob = light_ops.pick_light(scene, vdata['nee_pick'])
        nee_lprim0 = light_ops.sample_discrete(scene, nee_light,
                                               vdata['nee_disc'])
        n_contrib, n_ls, n_ss, n_mis, n_ok, n_lprim = direct_lighting(
            scene, opts, occluded_fn, state, time, nee_light, nee_lprim0,
            vdata['nee_rnd'], nee_prob)
        n_ok = n_ok & alive & (c + 2 >= md)

        # vertex connections -> slots (2+c, 2+l), all D light vertices in
        # one flattened call (one occlusion query of D*C rays)
        length = c + l_len + 3
        pre_ok = (alive.repeat(D) & lgt_exists_flat & (length <= mx)
                  & (length >= md))
        cam_flat = tree_map(lambda x: x.repeat((D,) + (1,) * (x.ndim - 1)),
                            state)
        v_contrib, v_ls, v_ss, v_mis, v_ok = connect_vertex(
            scene, opts, occluded_fn, time_flat, lgt_flat, cam_flat,
            mask=pre_ok)
        v_ok = v_ok & pre_ok
        unfl = lambda x: x.reshape((D, C) + x.shape[1:]).transpose(0, 1)

        new_d, new_state, b_contrib, use_abs, b_ok, rnd_canon, _, lc_jac = \
            bsdf_sampling(scene, opts, state, vdata['bsdf'], vdata['disc'],
                          c, adjoint=False)
        rr_prob = russian_roulette_prob(c, b_contrib)
        rr_ok = vdata['rr'] <= rr_prob
        rr_weight = 1.0 / torch.clamp(rr_prob, min=1e-12)
        cam.append(dict(
            lc_ok=lc_ok, lc_param=lc_param,
            tri=torch.where(exists, tid, torch.full_like(tid, -1)),
            disc=vdata['disc'], rnd_canon=rnd_canon, use_abs=use_abs,
            rr_weight=torch.where(rr_ok, rr_weight, torch.ones_like(rr_weight)),
            nee_light=nee_light, nee_lprim=n_lprim.to(torch.int32),
            nee_rnd=vdata['nee_rnd'], cam_alive=cam_alive_now,
            h_contrib=_masked(h_ok, h_contrib), h_ls=_masked(h_ok, h_ls),
            h_ss=_masked(h_ok, h_ss), h_mis=_masked(h_ok, h_mis),
            n_contrib=_masked(n_ok, n_contrib), n_ls=_masked(n_ok, n_ls),
            n_ss=_masked(n_ok, n_ss), n_mis=_masked(n_ok, n_mis),
            v_contrib=unfl(_masked(v_ok, v_contrib)),
            v_ls=unfl(_masked(v_ok, v_ls)), v_ss=unfl(_masked(v_ok, v_ss)),
            v_mis=unfl(_masked(v_ok, v_mis))))
        alive = alive & b_ok & rr_ok
        org, d = state.pos, new_d
        acc_prev, acc_this = new_state.acc_prev, new_state.acc_this
        throughput = new_state.throughput * rr_weight[..., None]
        ss_jac = new_state.ss_jacobian
        lc_jac_prev = lc_jac
        min_t, max_t = eps, inf

    stackc = lambda k: torch.stack([y[k] for y in cam], 1)
    cam_alive = stackc('cam_alive')
    rec = dataclasses.replace(
        rec, cam_tri=stackc('tri'),
        cam_bsdf_rnd=_shift_light_coords(opts, stackc('rnd_canon'),
                                         stackc('lc_ok'), stackc('lc_param')),
        cam_bsdf_disc=stackc('disc'), cam_use_abs=stackc('use_abs'),
        cam_rr=stackc('rr_weight'), cam_nee_light=stackc('nee_light'),
        cam_nee_lprim=stackc('nee_lprim'), cam_nee_rnd=stackc('nee_rnd'),
        env_lprim=env_lprim)

    def grid(h, n, v):
        # [C, D, D+2(, k)]: slot 0 hit light, 1 NEE, 2+l connections
        return torch.cat([stackc(h)[:, :, None], stackc(n)[:, :, None],
                          stackc(v)], 2)

    # every s >= 2 technique of a lane splats at this ONE camera screen
    # position (integrators.mlt.collapse_flat relies on it)
    scr = torch.broadcast_to(screen[:, None, None, :], (C, D, D + 2, 2))
    con = Contribs(
        screen_pos=scr,
        contrib=grid('h_contrib', 'n_contrib', 'v_contrib'),
        ls_score=grid('h_ls', 'n_ls', 'v_ls'),
        ss_score=grid('h_ss', 'n_ss', 'v_ss'),
        mis_weight=grid('h_mis', 'n_mis', 'v_mis'),
        l_screen_pos=stackl('cc_screen'), l_contrib=stackl('cc_contrib'),
        l_ls_score=stackl('cc_ls'), l_ss_score=stackl('cc_ss'),
        l_mis_weight=stackl('cc_mis'))
    return rec, con, lgt_alive, cam_alive


# ---------------------------------------------------------------------------
# fixed-(s, t) generation
# ---------------------------------------------------------------------------

def generate_subpath(scene, opts, tape: Tape, s, t, pixel=None):
    """Generate a wavefront of fixed-technique paths: lane i walks exactly
    s[i] camera vertices and t[i] light vertices and gives the one (s, t)
    contribution (the multiplexed large steps). Unlike generate_path_bidir:
    no Russian roulette, no min/max-depth filter, one contribution per
    lane. With opts.bidirectional false the MIS is the unidirectional
    power-2 balance (t is then 0 or 1).

    s, t: [C] int with s >= 1, t >= 0, s + t - 1 <= max_depth.
    Returns (PathRecord tagged with (s, t), dict(screen, contrib, ls, ss,
    mis, valid))."""
    D = opts.max_depth
    C = tape.u.shape[0]
    dev = tape.u.device
    intersect_fn, occluded_fn = make_intersect_fns(scene)
    spc = screen_pixel_count(scene)
    s = torch.as_tensor(s, dtype=torch.int32, device=dev)
    t = torch.as_tensor(t, dtype=torch.int32, device=dev)
    ones_b = torch.ones(C, dtype=torch.bool, device=dev)
    eps = torch.full((C,), vm.ISECT_EPS, device=dev)
    inf = torch.full((C,), INF, device=dev)
    bidir_mis = bool(getattr(opts, 'bidirectional', True))

    time = tape.time
    rec = dataclasses.replace(empty_record(C, D, dev), time=time)

    # ---- light subpath: t >= 2 lanes walk t - 1 vertices ----
    em, emission_pdf, throughput, finite_light, acc_prev, acc_this, rec = \
        _light_start(scene, tape, rec)
    org, d = em['org'], em['dir']
    alive = (t >= 2) & (emission_pdf > 0.0)
    ss_jac = torch.ones(C, device=dev)
    lgt = []
    cc = None        # connect-to-camera at the terminal light vertex
    lterm = None     # terminal light state, for the vertex connection
    lterm_exists = torch.zeros_like(ones_b)
    for l in range(D):
        vdata = tape.lgt_vertex(l)
        hit_out = intersect_fn(org, d, time, eps, inf)
        hit, tid = hit_out[0], hit_out[1]
        exists = alive & hit
        state, _ = _surf(scene, org, d, hit_out, time, acc_prev, acc_this,
                         throughput, ss_jac,
                         torch.where(exists, tid, torch.full_like(tid, -1)))
        state = convert_mis(state, org, d, finite_light if l == 0 else ones_b)
        is_term = t - 2 == l
        cc_l = connect_to_camera(scene, opts, occluded_fn, time, state, spc)
        cc_ok = cc_l[5] & exists & is_term & (s == 1)
        cc_l = cc_l[:5] + (cc_ok,)
        cc = cc_l if cc is None else tuple(
            _where_lane(is_term, a, b) for a, b in zip(cc_l, cc))
        lterm = state if lterm is None else tree_where(is_term, state, lterm)
        lterm_exists = torch.where(is_term, exists, lterm_exists)

        new_d, new_state, _, use_abs, b_ok, rnd_canon, _, _ = bsdf_sampling(
            scene, opts, state, vdata['bsdf'], vdata['disc'], l, adjoint=True)
        extend = exists & (l < t - 2)
        lgt.append(dict(
            tri=state.tri, disc=vdata['disc'],
            rnd_canon=_masked(extend, rnd_canon), use_abs=use_abs & extend))
        alive = extend & b_ok
        org, d = state.pos, new_d
        acc_prev, acc_this = new_state.acc_prev, new_state.acc_this
        throughput, ss_jac = new_state.throughput, new_state.ss_jacobian

    stackl = lambda k: torch.stack([y[k] for y in lgt], 1)
    rec = dataclasses.replace(
        rec, lgt_tri=stackl('tri'), lgt_bsdf_rnd=stackl('rnd_canon'),
        lgt_bsdf_disc=stackl('disc'), lgt_use_abs=stackl('use_abs'))

    # s == 1 lanes: the connect-to-camera at light vertex t - 2
    cc_screen, cc_contrib, cc_ls, cc_ss, cc_mis, cc_ok = cc
    s1 = (s == 1) & cc_ok
    res = dict(screen=_masked(s1, cc_screen), contrib=_masked(s1, cc_contrib),
               ls=_masked(s1, cc_ls), ss=_masked(s1, cc_ss),
               mis=_masked(s1, cc_mis), valid=s1,
               env=torch.full((C,), -1, dtype=torch.int32, device=dev))

    # ---- camera subpath: s >= 2 lanes walk s - 1 vertices ----
    if pixel is None:
        screen = tape.screen
    else:
        f = torch.get_default_dtype()
        screen = (pixel.to(f) + tape.screen) / torch.tensor(
            [scene.width, scene.height], dtype=f, device=dev)
    rec = dataclasses.replace(rec, screen_pos=screen)
    org, d, min_t, max_t = sample_primary(scene.camera, screen, time)
    _, cam_center = camera_center_dir(scene.camera, time)
    alive = s >= 2
    has_env = scene.env_light_id >= 0
    acc_prev = MIS(spc / camera_pdf_w(scene, cam_center, d))
    acc_this = torch.zeros(C, device=dev)
    throughput = torch.ones((C, 3), device=dev)
    ss_jac = torch.ones(C, device=dev)
    lc_jac_prev = torch.ones(C, device=dev)
    last_pdf = torch.zeros(C, device=dev)
    cam = []
    for c in range(D):
        vdata = tape.cam_vertex(c)
        hit_out = intersect_fn(org, d, time, min_t, max_t)
        hit, tid = hit_out[0], hit_out[1]
        state, light_id = _surf(scene, org, d, hit_out, time, acc_prev,
                                acc_this, throughput, ss_jac, tid)
        if bidir_mis:
            st_mis = convert_mis(state, org, d, ones_b)
            state = dataclasses.replace(
                state, acc_prev=torch.where(hit, st_mis.acc_prev,
                                            state.acc_prev),
                acc_this=torch.where(hit, st_mis.acc_this, state.acc_this))
        terminal = alive & (s - 2 == c)

        # t == 0: the terminal vertex hits a light or escapes to the env map
        hit_light_id = torch.where(hit, light_id, torch.full_like(light_id, -1))
        is_env_hit = ~hit & terminal & has_env
        hit_light = (hit & (hit_light_id >= 0)) | is_env_hit
        h_contrib, h_ls, h_ss, h_mis, h_ok = handle_hit_light(
            scene, torch.full((C,), c == 0, device=dev), hit, hit_light_id, d,
            time, state, bidir_mis=bidir_mis, ray_org=org,
            last_bsdf_pdf=last_pdf)
        h_ok = h_ok & terminal & (t == 0) & hit_light
        lc_ok, lc_param, h_ss = _light_coords(scene, opts, c, h_ok, hit,
                                              hit_light_id, tid, state, org,
                                              time, lc_jac_prev, h_ss)
        if has_env:
            env_pix = light_ops.env_emission(scene, d, time)[0]
            res['env'] = torch.where(is_env_hit & h_ok, env_pix, res['env'])
        exists = alive & hit

        # t == 1: NEE at the terminal vertex
        nee_light, nee_prob = light_ops.pick_light(scene, vdata['nee_pick'])
        nee_lprim0 = light_ops.sample_discrete(scene, nee_light,
                                               vdata['nee_disc'])
        n_contrib, n_ls, n_ss, n_mis, n_ok, n_lprim = direct_lighting(
            scene, opts, occluded_fn, state, time, nee_light, nee_lprim0,
            vdata['nee_rnd'], nee_prob, bidir_mis=bidir_mis)
        n_ok = n_ok & exists & terminal & (t == 1)

        # t >= 2: connect to the terminal light vertex
        v_contrib, v_ls, v_ss, v_mis, v_ok = connect_vertex(
            scene, opts, occluded_fn, time, lterm, state)
        v_ok = v_ok & exists & terminal & (t >= 2) & lterm_exists

        for ok, vals in ((v_ok, (v_contrib, v_ls, v_ss, v_mis)),
                         (n_ok, (n_contrib, n_ls, n_ss, n_mis)),
                         (h_ok, (h_contrib, h_ls, h_ss, h_mis))):
            for k, v in zip(('contrib', 'ls', 'ss', 'mis'), vals):
                res[k] = _where_lane(ok, v, res[k])
        any_ok = h_ok | n_ok | v_ok
        res['screen'] = _where_lane(any_ok, screen, res['screen'])
        res['valid'] = res['valid'] | any_ok

        new_d, new_state, _, use_abs, b_ok, rnd_canon, pdf, lc_jac = \
            bsdf_sampling(scene, opts, state, vdata['bsdf'], vdata['disc'],
                          c, adjoint=False)
        extend = exists & (c < s - 2)
        cam.append(dict(
            tri=torch.where(exists, tid, torch.full_like(tid, -1)),
            disc=vdata['disc'], rnd_canon=_masked(extend, rnd_canon),
            use_abs=use_abs & extend, lc_ok=lc_ok, lc_param=lc_param,
            nee_light=nee_light, nee_lprim=n_lprim.to(torch.int32),
            nee_rnd=vdata['nee_rnd']))
        alive = extend & b_ok
        org, d = state.pos, new_d
        acc_prev, acc_this = new_state.acc_prev, new_state.acc_this
        throughput, ss_jac = new_state.throughput, new_state.ss_jacobian
        lc_jac_prev, last_pdf = lc_jac, pdf
        min_t, max_t = eps, inf

    stackc = lambda k: torch.stack([y[k] for y in cam], 1)
    rec = dataclasses.replace(
        rec, cam_tri=stackc('tri'),
        cam_bsdf_rnd=_shift_light_coords(opts, stackc('rnd_canon'),
                                         stackc('lc_ok'), stackc('lc_param')),
        cam_bsdf_disc=stackc('disc'), cam_use_abs=stackc('use_abs'),
        cam_nee_light=stackc('nee_light'), cam_nee_lprim=stackc('nee_lprim'),
        cam_nee_rnd=stackc('nee_rnd'), env_lprim=res['env'])
    rec = to_subpath(rec, s, t)
    return rec, dict(screen=res['screen'], contrib=res['contrib'],
                     ls=res['ls'], ss=res['ss'], mis=res['mis'],
                     valid=res['valid'] & (res['ls'] > 0.0))


def _where_lane(ok, a, b):
    return torch.where(ok.reshape(ok.shape + (1,) * (a.ndim - ok.ndim)), a, b)


# ---------------------------------------------------------------------------
# unidirectional generation
# ---------------------------------------------------------------------------

def generate_path_uni(scene, opts, tape: Tape, pixel=None, min_depth=None,
                      max_depth=None):
    """Unidirectional path tracing with NEE and power-2 MIS (the direct
    lighting pass). Returns (PathRecord, Contribs); only slots (2+c, 0)
    and (2+c, 1) fill."""
    D = opts.max_depth
    min_depth = opts.min_depth if min_depth is None else min_depth
    max_depth = opts.max_depth if max_depth is None else max_depth
    C = tape.u.shape[0]
    dev = tape.u.device
    intersect_fn, occluded_fn = make_intersect_fns(scene)
    eps = torch.full((C,), vm.ISECT_EPS, device=dev)
    inf = torch.full((C,), INF, device=dev)

    time = tape.time
    rec = dataclasses.replace(empty_record(C, D, dev), time=time)
    con = empty_contribs(C, D, dev)
    if pixel is None:
        screen = tape.screen
    else:
        f = torch.get_default_dtype()
        screen = (pixel.to(f) + tape.screen) / torch.tensor(
            [scene.width, scene.height], dtype=f, device=dev)
    rec.screen_pos = screen
    org, d, min_t, max_t = sample_primary(scene.camera, screen, time)
    throughput = torch.ones((C, 3), device=dev)
    last_bsdf_pdf = torch.ones(C, device=dev)
    ss_jac = torch.ones(C, device=dev)
    alive = torch.ones(C, dtype=torch.bool, device=dev)
    has_env = scene.env_light_id >= 0

    steps = D if max_depth == -1 else min(D, max_depth)
    for c in range(steps):
        hit_out = intersect_fn(org, d, time, min_t, max_t)
        hit, tid = hit_out[0], hit_out[1]
        state, light_id = _surf(scene, org, d, hit_out, time,
                                torch.zeros(C, device=dev),
                                torch.zeros(C, device=dev), throughput,
                                ss_jac, tid)
        pos, sn, mat = state.pos, state.shading_n, state.mat
        vdata = tape.cam_vertex(c)
        hit_light_id = torch.where(hit, light_id, torch.full_like(light_id, -1))
        is_env_hit = ~hit & alive & has_env
        hit_light = alive & ((hit & (hit_light_id >= 0)) | is_env_hit)
        exists = alive & hit
        rec.cam_tri[:, c] = torch.where(exists, tid, torch.full_like(tid, -1))
        rec.cam_bsdf_disc[:, c] = vdata['disc']

        if c + 1 >= min_depth or min_depth == -1:
            lid = torch.clamp(hit_light_id, min=0)
            em, direct_pdf, _ = light_ops.area_emission(scene, lid, d, sn)
            # area pdf -> solid angle
            dist_sq = vm.distance_squared(org, pos)
            safe_cos = vm.clamp_abs(-vm.dot(d, sn))
            direct_pdf = direct_pdf * dist_sq / safe_cos
            lpp = light_ops.pick_light_prob(scene, lid)
            if has_env:
                env_pix, em_e, dpdf_e, _ = light_ops.env_emission(scene, d,
                                                                  time)
                em = torch.where(hit[:, None], em, em_e)
                direct_pdf = torch.where(hit, direct_pdf, dpdf_e)
                lpp = torch.where(hit, lpp, light_ops.pick_light_prob(
                    scene, torch.full_like(lid, scene.env_light_id)))
            else:
                em = torch.where(hit[:, None], em, torch.zeros_like(em))
            h_ok = (torch.sum(em, -1) > 0.0) & hit_light
            contrib = throughput * em
            mis_w = vm.mis_weight_power2(last_bsdf_pdf, direct_pdf * lpp) \
                if c > 0 else torch.ones_like(direct_pdf)
            contrib = contrib * mis_w[..., None]
            score = vm.luminance(contrib)
            h_ok = h_ok & (score > 0.0)
            if has_env:
                rec.env_lprim = torch.where(is_env_hit & h_ok, env_pix,
                                            rec.env_lprim)
            con.screen_pos[:, c, 0] = _masked(h_ok, screen)
            con.contrib[:, c, 0] = _masked(h_ok, contrib)
            con.ls_score[:, c, 0] = _masked(h_ok, score)
            con.ss_score[:, c, 0] = _masked(h_ok, score * ss_jac)
            con.mis_weight[:, c, 0] = _masked(h_ok, mis_w)
            alive = alive & ~hit_light

        alive = alive & hit
        if max_depth != -1 and c + 1 >= max_depth:
            break

        if c + 2 >= min_depth or min_depth == -1:
            nee_light, nee_prob = light_ops.pick_light(scene, vdata['nee_pick'])
            nee_lprim = light_ops.sample_discrete(scene, nee_light,
                                                  vdata['nee_disc'])
            rec.cam_nee_light[:, c] = nee_light
            rec.cam_nee_lprim[:, c] = nee_lprim
            rec.cam_nee_rnd[:, c] = vdata['nee_rnd']
            out = light_ops.sample_direct(scene, nee_light, nee_lprim,
                                          vdata['nee_rnd'], pos, time)
            n_ok = out['valid'] & alive
            occ = occluded_fn(pos, out['dir_to_light'], time, eps,
                              (1.0 - vm.SHADOW_EPS) * out['dist'])
            n_ok = n_ok & ~occ
            b_contrib, _, bsdf_pdf, _ = bsdf_ops.evaluate(
                mat, -d, sn, out['dir_to_light'])
            n_ok = n_ok & (torch.amax(torch.abs(b_contrib), -1) > 0.0)
            n_contrib = (throughput * b_contrib * out['contrib']
                         / torch.clamp(nee_prob, min=1e-12)[..., None])
            delta = light_ops.is_delta(scene, nee_light)
            n_mis = vm.mis_weight_power2(out['direct_pdf'] * nee_prob,
                                         bsdf_pdf)
            n_mis = torch.where(delta, torch.ones_like(n_mis), n_mis)
            n_contrib = torch.where(delta[..., None], n_contrib,
                                    n_contrib * n_mis[..., None])
            n_score = vm.luminance(n_contrib)
            n_ok = n_ok & (n_score > 0.0)
            con.screen_pos[:, c, 1] = _masked(n_ok, screen)
            con.contrib[:, c, 1] = _masked(n_ok, n_contrib)
            con.ls_score[:, c, 1] = _masked(n_ok, n_score)
            con.ss_score[:, c, 1] = _masked(n_ok, n_score * ss_jac)
            con.mis_weight[:, c, 1] = _masked(n_ok, n_mis)

        new_d, new_state, b_contrib, use_abs, b_ok, rnd_canon, pdf, _ = \
            bsdf_sampling(scene, opts, state, vdata['bsdf'], vdata['disc'], c,
                          adjoint=False)
        rr_prob = russian_roulette_prob(c, b_contrib)
        rr_ok = vdata['rr'] <= rr_prob
        rr_weight = 1.0 / torch.clamp(rr_prob, min=1e-12)
        rec.cam_bsdf_rnd[:, c] = rnd_canon
        rec.cam_use_abs[:, c] = use_abs
        rec.cam_rr[:, c] = torch.where(rr_ok, rr_weight,
                                       torch.ones_like(rr_weight))
        alive = alive & b_ok & rr_ok
        throughput = new_state.throughput * rr_weight[..., None]
        ss_jac = new_state.ss_jacobian
        last_bsdf_pdf = pdf
        org, d = pos, new_d
        min_t, max_t = eps, inf
    return rec, con
