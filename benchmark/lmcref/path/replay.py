"""Path replay: perturbation re-trace and frozen differentiable replay
(port of path/replay.py).

* mode='perturb': real scene intersection (topology may change), occlusion
  on, discrete values jittered by the given noise, stored rrWeights
  multiplied in. Returns the single (s,t) contribution and the updated
  PathRecord.
* mode='frozen': intersects the frozen per-vertex triangles with no
  validity checks and no occlusion — a differentiable function of the PSS
  offset; ``path_grad`` is one autograd backward of its summed
  log-luminance.

Every lane runs the padded max_depth steps with masks; the terminal
connection of each kind is evaluated once after the walk on the selected
last states.
"""

import dataclasses

import torch

from ..utils import vecmath as vm
from ..utils.tree import tree_map, tree_where
from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops.intersect import (make_intersect_fns, gather_tri_row_raw,
                             row_dict_from_raw, frozen_from_row,
                             hit_attrs_from_row)
from ..scene.camera import sample_primary
from .records import apply_pss_offset
from . import trace as tr

MIS = vm.mis
INF = float('inf')


def _replay_nee(scene, rec, c_idx, state, time, frozen, occluded_fn, opts,
                mask=None, occ_in=None, pack=None):
    """Next-event estimation at the terminal camera vertex with the
    record's light instance; in frozen mode an env light's pixel stays the
    recorded one. Returns (contrib, ls, ss, mis, valid)."""
    C = rec.time.shape[0]
    lanes = torch.arange(C, device=rec.time.device)
    light_id = torch.clamp(rec.cam_nee_light[lanes, c_idx], min=0)
    lprim = rec.cam_nee_lprim[lanes, c_idx]
    nee_rnd = rec.cam_nee_rnd[lanes, c_idx]
    light_pick_prob = pack['pick_prob'] if pack is not None \
        else light_ops.pick_light_prob(scene, light_id)
    out = light_ops.sample_direct(scene, light_id, lprim, nee_rnd,
                                  state.pos, time, pack=pack,
                                  skip_env=frozen)
    valid = out['valid']
    if frozen:
        occ_ok = torch.ones_like(valid)
        if scene.env_light_id >= 0:
            ltype = pack['ltype'] if pack is not None \
                else scene.light_type[light_id.long()]
            is_env = ltype == light_ops.LIGHT_ENV
            env_pack = pack['env'] if pack is not None \
                else light_ops.bake_env_pixel(scene, lprim)
            d_w, value, pdf = light_ops.frozen_env_sample_direction(
                scene, env_pack, nee_rnd, time)
            out = dict(out)
            out['dir_to_light'] = _where(is_env, d_w, out['dir_to_light'])
            out['contrib'] = _where(is_env,
                                    value / vm.clamp_abs(pdf)[..., None],
                                    out['contrib'])
            out['direct_pdf'] = torch.where(is_env, pdf, out['direct_pdf'])
            out['emission_pdf'] = torch.where(
                is_env, pdf * scene.env_position_pdf, out['emission_pdf'])
            out['dist'] = torch.where(is_env, torch.full_like(pdf, INF),
                                      out['dist'])
            valid = valid | is_env
    elif occ_in is not None:
        occ_ok = ~occ_in
    else:
        occ_max = (1.0 - vm.SHADOW_EPS) * out['dist']
        if mask is not None:
            occ_max = torch.where(mask, occ_max, torch.zeros_like(occ_max))
        occ_ok = ~occluded_fn(state.pos, out['dir_to_light'], time,
                              torch.full_like(time, vm.ISECT_EPS), occ_max)
    b_contrib, cos_to_light, bsdf_pdf, bsdf_rev_pdf = bsdf_ops.evaluate(
        state.mat, state.wi, state.shading_n, out['dir_to_light'])
    valid = valid & (torch.amax(torch.abs(b_contrib), -1) > 0.0)
    factor = tr.shading_normal_correction(
        state.wi, state.shading_n, state.geom_n, out['dir_to_light'], False)
    valid = valid & (factor > 0.0) & occ_ok
    b_contrib = b_contrib * factor[..., None]
    contrib = (state.throughput * b_contrib * out['contrib']
               / torch.clamp(light_pick_prob, min=1e-12)[..., None])
    mis_w = tr._nee_mis(scene, light_id, out, light_pick_prob, bsdf_pdf,
                        bsdf_rev_pdf, cos_to_light, state)
    contrib = contrib * mis_w[..., None]
    score = vm.luminance(contrib)
    valid = valid & (score > 0.0)
    return contrib, score, score * state.ss_jacobian, mis_w, valid


def _replay_emit(scene, rec, time, frozen, pack=None):
    """Light::Emit with the record's light instance; in frozen mode an env
    light's pixel stays the recorded one (rec.lgt_lprim), so only the
    offsets within it differentiate."""
    lid = torch.clamp(rec.lgt_light_id, min=0)
    out = light_ops.emit(scene, lid, rec.lgt_lprim, rec.lgt_rnd_pos,
                         rec.lgt_rnd_dir, time, pack=pack, skip_env=frozen)
    if not (frozen and scene.env_light_id >= 0):
        return out
    env_pack = pack['env'] if pack is not None \
        else light_ops.bake_env_pixel(scene, rec.lgt_lprim)
    d_s, em_e, dpdf_e = light_ops.frozen_env_sample_direction(
        scene, env_pack, rec.lgt_rnd_dir, time)
    org_e, d_e = light_ops.env_emit_ray(scene, d_s, rec.lgt_rnd_pos)
    ltype = pack['ltype'] if pack is not None \
        else scene.light_type[lid.long()]
    is_env = ltype == light_ops.LIGHT_ENV
    out = dict(out)
    out['org'] = _where(is_env, org_e, out['org'])
    out['dir'] = _where(is_env, d_e, out['dir'])
    out['emission'] = _where(is_env, em_e, out['emission'])
    out['emission_pdf'] = torch.where(is_env, dpdf_e * scene.env_position_pdf,
                                      out['emission_pdf'])
    out['direct_pdf'] = torch.where(is_env, dpdf_e, out['direct_pdf'])
    return out


def _zero_state(scene, C, dev):
    """Placeholder last-light-state for lanes without a light subpath.
    Geometrically non-degenerate (unit normals, off-origin position): its
    connect_vertex results are masked out, but a degenerate state would
    push inf partials through the masked branch into the reverse pass."""
    z = torch.zeros(C, device=dev)
    up = torch.zeros((C, 3), device=dev)
    up[:, 2] = 1.0
    return tr.SurfState(
        pos=scene.bsphere_center + up, shading_n=up, geom_n=up,
        st=torch.zeros((C, 2), device=dev), wi=up,
        mat=bsdf_ops.gather_mat_params(
            scene, torch.zeros(C, dtype=torch.long, device=dev),
            torch.zeros((C, 2), device=dev)),
        tri=torch.zeros(C, dtype=torch.int32, device=dev), acc_prev=z,
        acc_this=z, throughput=torch.zeros((C, 3), device=dev),
        ss_jacobian=z)


def _where(p, a, b):
    return torch.where(p.reshape(p.shape + (1,) * (a.ndim - p.ndim)), a, b)


def replay_path(scene, opts, rec, offset, noise, mode='perturb', bake=None,
                collect_bake=False):
    """Replay the record's (s,t) subpath with PSS offsets applied.

    rec: PathRecord tagged by to_subpath. offset: [C, 2*max_depth].
    noise: dict(time [C], cam_disc [C,D], lgt_disc [C,D]) of gaussian
    jitters (perturb mode; None when frozen).

    bake / collect_bake: every per-lane scene constant the replay reads
    (packed triangle rows, material parameters, light packs). With
    collect_bake=True a third output holds the bake of THIS replay's output
    record; frozen mode consumes it with bake=<that>. Primal values are the
    same either way, and every baked quantity is a constant of the offset
    in frozen mode. Static scenes only: on a moving scene each vertex's
    triangle row is lerped at the record's time on every replay.

    Returns (new_rec, result) or (new_rec, result, bake); result =
    dict(contrib, ls_score, ss_score, screen_pos, mis_weight, valid)."""
    frozen = mode == 'frozen'
    D = rec.max_depth
    C = rec.time.shape[0]
    dev = rec.time.device
    rec = apply_pss_offset(rec, offset)
    if not frozen:
        rec = dataclasses.replace(
            rec, time=vm.modulo(rec.time + noise['time'], 1.0),
            cam_bsdf_disc=vm.modulo(rec.cam_bsdf_disc + noise['cam_disc'],
                                    1.0),
            lgt_bsdf_disc=vm.modulo(rec.lgt_bsdf_disc + noise['lgt_disc'],
                                    1.0))
    time = rec.time
    s = rec.cam_depth
    t = rec.lgt_depth
    intersect_fn, occluded_fn = make_intersect_fns(scene)
    spc = tr.screen_pixel_count(scene)
    use_bake = bake is not None
    if use_bake and (collect_bake or not frozen):
        raise ValueError('a bake is consumed by frozen replay only')
    if (use_bake or collect_bake) and scene.has_motion:
        raise ValueError('path bake requires a static scene')
    lanes = torch.arange(C, device=dev)
    c_idx = torch.clamp(s - 2, 0, D - 1).long()
    if use_bake:
        emit_pack, nee_pack = bake['emit'], bake['nee']
    elif collect_bake:
        emit_pack = light_ops.bake_light(scene, rec.lgt_light_id,
                                         rec.lgt_lprim)
        nee_pack = light_ops.bake_light(scene, rec.cam_nee_light[lanes, c_idx],
                                        rec.cam_nee_lprim[lanes, c_idx])
    else:
        emit_pack = nee_pack = None
    ones_b = torch.ones(C, dtype=torch.bool, device=dev)
    eps = torch.full((C,), vm.ISECT_EPS, device=dev)
    inf = torch.full((C,), INF, device=dev)

    def mat_at(tri, st):
        # frozen: texture values are constants of the offset
        return bsdf_ops.gather_mat_params(scene, scene.tri_mat[tri],
                                          st.detach() if frozen else st)

    # ---------------- light subpath ----------------
    has_lgt = t >= 2
    lid = torch.clamp(rec.lgt_light_id, min=0)
    if emit_pack is not None:
        light_pick_prob = emit_pack['pick_prob']
        delta_light = emit_pack['is_delta']
        finite_light = emit_pack['is_finite']
    else:
        light_pick_prob = light_ops.pick_light_prob(scene, lid)
        delta_light = light_ops.is_delta(scene, lid)
        finite_light = light_ops.is_finite(scene, lid)
    em = _replay_emit(scene, rec, time, frozen, pack=emit_pack)
    emission_pdf = em['emission_pdf'] * light_pick_prob
    direct_pdf = em['direct_pdf'] * light_pick_prob
    lthroughput = em['emission'] / torch.clamp(light_pick_prob,
                                               min=1e-12)[..., None]
    safe_epdf = vm.clamp_abs(emission_pdf)
    lacc_prev = MIS(direct_pdf / safe_epdf)
    lacc_this = MIS(em['cos_at_light'] / safe_epdf)
    lacc_this = torch.where(delta_light, torch.zeros_like(lacc_this),
                            lacc_this)
    lorg, ld = em['org'], em['dir']
    lgt_ok = ones_b
    lss_jac = torch.ones(C, device=dev)
    last_state = _zero_state(scene, C, dev)

    # ---------------- camera subpath ----------------
    has_cam = s >= 2
    org, d, min_t, max_t = sample_primary(scene.camera, rec.screen_pos, time)
    _, cam_center = tr.camera_center_dir(scene.camera, time)
    acc_prev = MIS(spc / tr.camera_pdf_w(scene, cam_center, d))
    acc_this = torch.zeros(C, device=dev)
    throughput = torch.ones((C, 3), device=dev)
    ss_jac = torch.ones(C, device=dev)
    cam_ok = ones_b
    term_state = _zero_state(scene, C, dev)
    term_org = torch.zeros((C, 3), device=dev)
    term_d = torch.zeros((C, 3), device=dev)
    term_d[:, 2] = 1.0
    term_hit = torch.zeros(C, dtype=torch.bool, device=dev)

    # light-coordinate lanes: (s, 0) subpaths whose recorded last vertex
    # lies on an area light sample that light's triangle at the (perturbed)
    # parameters of vertex s - 3 instead of sampling the BSDF there. Gated
    # s >= 4, as generation reparameterises only camera vertices c > 1.
    lc_enabled = bool(opts.use_light_coordinate_sampling)
    if lc_enabled:
        tri_last = rec.cam_tri[lanes, c_idx]
        tri_last_safe = torch.clamp(tri_last, min=0).long()
        lc_lane = ((t == 0) & (s >= 4) & (tri_last >= 0)
                   & (scene.tri_light[tri_last_safe] >= 0))
        # the perturb replay's shadow ray to the sampled light point joins
        # the terminals' occlusion query (t == 0 lanes shoot no other)
        lc_fired = torch.zeros_like(lc_lane)
        lc_org = torch.zeros((C, 3), device=dev)
        lc_dir = term_d.clone()
        lc_max = torch.zeros(C, device=dev)

    new_lgt_tri, new_cam_tri, collected = [], [], []
    # Both subpaths advance in lockstep; in perturb mode one intersection
    # query per step covers the concatenated [2C] light + camera rays.
    for step in range(D):
        l = c = step
        lv_tri, cv_tri = rec.lgt_tri[:, l], rec.cam_tri[:, c]
        l_active = has_lgt & (l < t - 1)
        active = has_cam & (c < s - 1)
        is_last = active & (c == s - 2)

        if frozen:
            l_tri = torch.clamp(lv_tri, min=0).long()
            tri = torch.clamp(cv_tri, min=0).long()
            l_raw = bake['lgt_row'][:, l] if use_bake \
                else gather_tri_row_raw(scene, l_tri, time)
            c_raw = bake['cam_row'][:, c] if use_bake \
                else gather_tri_row_raw(scene, tri, time)
            lpos, lsn, lgn, lst, _ = frozen_from_row(row_dict_from_raw(l_raw),
                                                     lorg, ld)
            pos, sn, gn, st, _ = frozen_from_row(row_dict_from_raw(c_raw),
                                                 org, d)
            l_hit = ones_b
            # a recorded env hit ends the camera subpath off every triangle
            hit = ~(is_last & (t == 0) & (rec.env_lprim >= 0))
            new_lgt_tri.append(lv_tri)
            new_cam_tri.append(cv_tri)
        else:
            l_max = torch.where(l_active, inf, torch.zeros_like(inf))
            c_max = torch.where(active, max_t, torch.zeros_like(max_t))
            hit2, tid2, th2, uh2, vh2 = intersect_fn(
                torch.cat([lorg, org]), torch.cat([ld, d]),
                torch.cat([time, time]), torch.cat([eps, min_t]),
                torch.cat([l_max, c_max]))
            l_hit, hit = hit2[:C], hit2[C:]
            l_tri, tri = tid2[:C].long(), tid2[C:].long()
            l_raw = gather_tri_row_raw(scene, l_tri, time)
            c_raw = gather_tri_row_raw(scene, tri, time)
            lpos, lsn, lgn, lst = hit_attrs_from_row(
                row_dict_from_raw(l_raw), lorg, ld, th2[:C], uh2[:C], vh2[:C])
            pos, sn, gn, st = hit_attrs_from_row(
                row_dict_from_raw(c_raw), org, d, th2[C:], uh2[C:], vh2[C:])
            new_lgt_tri.append(torch.where(l_active & l_hit,
                                           l_tri.to(torch.int32), lv_tri))
            new_cam_tri.append(torch.where(active & hit, tri.to(torch.int32),
                                           cv_tri))

        # --- light-side step ---
        lgt_ok = lgt_ok & torch.where(l_active, l_hit, ones_b)
        l_mat = tree_map(lambda x: x[:, l], bake['lgt_mat']) if use_bake \
            else mat_at(l_tri, lst)
        l_state = tr.SurfState(pos=lpos, shading_n=lsn, geom_n=lgn, st=lst,
                               wi=-ld, mat=l_mat, tri=l_tri,
                               acc_prev=lacc_prev, acc_this=lacc_this,
                               throughput=lthroughput, ss_jacobian=lss_jac)
        l_state = tr.convert_mis(l_state, lorg, ld,
                                 finite_light if l == 0 else ones_b)
        l_is_last = l_active & (l == t - 2)
        last_state = tree_where(l_is_last, l_state, last_state)
        l_cont = l_active & ~l_is_last
        # non-extending steps see safe randoms (0.5): zeros are not valid
        # sphere parameters and their partials would turn into NaN through
        # the masking wheres
        l_rnd_in = _where(l_cont, rec.lgt_bsdf_rnd[:, l],
                          torch.full_like(rec.lgt_bsdf_rnd[:, l], 0.5))
        l_new_d, l_new_state, _, _, l_b_ok, _, _, _ = tr.bsdf_sampling(
            scene, opts, l_state, l_rnd_in, rec.lgt_bsdf_disc[:, l], l,
            adjoint=True, perturb=True, use_abs_in=rec.lgt_use_abs[:, l])
        lgt_ok = lgt_ok & torch.where(l_cont, l_b_ok, ones_b)
        lthroughput = _where(l_cont, l_new_state.throughput
                             * rec.lgt_rr[:, l, None], lthroughput)
        lacc_prev = _where(l_cont, l_new_state.acc_prev, lacc_prev)
        lacc_this = _where(l_cont, l_new_state.acc_this, lacc_this)
        lss_jac = _where(l_cont, l_new_state.ss_jacobian, lss_jac)
        lorg = _where(l_cont, l_state.pos, lorg)
        ld = _where(l_cont, l_new_d, ld)

        # --- camera-side step ---
        mat = tree_map(lambda x: x[:, c], bake['cam_mat']) if use_bake \
            else mat_at(tri, st)
        state = tr.SurfState(pos=pos, shading_n=sn, geom_n=gn, st=st, wi=-d,
                             mat=mat, tri=tri, acc_prev=acc_prev,
                             acc_this=acc_this, throughput=throughput,
                             ss_jacobian=ss_jac)
        st_mis = tr.convert_mis(state, org, d, ones_b)
        state = dataclasses.replace(
            state, acc_prev=torch.where(hit, st_mis.acc_prev, state.acc_prev),
            acc_this=torch.where(hit, st_mis.acc_this, state.acc_this))
        cam_ok = cam_ok & torch.where(active & ~is_last, hit, ones_b)
        term_state = tree_where(is_last, state, term_state)
        term_org = _where(is_last, org, term_org)
        term_d = _where(is_last, d, term_d)
        term_hit = torch.where(is_last, hit, term_hit)

        cont = active & ~is_last
        half = torch.full_like(rec.cam_bsdf_rnd[:, c], 0.5)
        rnd_in = _where(cont, rec.cam_bsdf_rnd[:, c], half)
        lc_now = None
        if lc_enabled and 1 <= c <= D - 2:
            lc_now = lc_lane & cont & (s - 3 == c)
            lc_rnd_in = _where(lc_now, rec.cam_bsdf_rnd[:, c], half)
            rnd_in = _where(lc_now, half, rnd_in)
        new_d, new_state, _, _, b_ok, _, _, _ = tr.bsdf_sampling(
            scene, opts, state, rnd_in, rec.cam_bsdf_disc[:, c], c,
            adjoint=False, perturb=True, use_abs_in=rec.cam_use_abs[:, c])
        thr_next = new_state.throughput
        accp_next, acct_next = new_state.acc_prev, new_state.acc_this
        ssj_next = new_state.ss_jacobian
        if lc_now is not None:
            lc = _light_coord_step(scene, state, tri_last_safe, lc_rnd_in,
                                   time)
            new_d = _where(lc_now, lc['dir'], new_d)
            b_ok = torch.where(lc_now, lc['valid'], b_ok)
            thr_next = _where(lc_now, lc['throughput'], thr_next)
            accp_next = torch.where(lc_now, lc['acc_prev'], accp_next)
            acct_next = torch.where(lc_now, lc['acc_this'], acct_next)
            ssj_next = torch.where(lc_now, lc['ss_jacobian'], ssj_next)
            if not frozen:
                lc_fired = lc_fired | lc_now
                lc_org = _where(lc_now, state.pos, lc_org)
                lc_dir = _where(lc_now, lc['dir'], lc_dir)
                lc_max = torch.where(lc_now, (1.0 - vm.SHADOW_EPS)
                                     * lc['dist'], lc_max)
        cam_ok = cam_ok & torch.where(cont, b_ok, ones_b)
        throughput = _where(cont, thr_next * rec.cam_rr[:, c, None],
                            throughput)
        acc_prev = _where(cont, accp_next, acc_prev)
        acc_this = _where(cont, acct_next, acc_this)
        ss_jac = _where(cont, ssj_next, ss_jac)
        org = _where(cont, state.pos, org)
        d = _where(cont, new_d, d)
        min_t, max_t = eps, inf
        if collect_bake:
            collected.append((l_raw, l_mat, c_raw, mat))

    if not frozen:
        rec = dataclasses.replace(rec, lgt_tri=torch.stack(new_lgt_tri, 1),
                                  cam_tri=torch.stack(new_cam_tri, 1))

    # ---------------- terminals, evaluated once ----------------
    term_hit = term_hit & has_cam
    has_env = scene.env_light_id >= 0
    # frozen mode keeps the record's env hit; perturb mode finds its own
    if frozen:
        env_case = has_cam & (t == 0) & (rec.env_lprim >= 0)
    else:
        env_case = has_cam & (t == 0) & ~term_hit & has_env
    hit_light_id = torch.where(
        term_hit, scene.tri_light[torch.clamp(term_state.tri, min=0).long()],
        torch.full_like(s, -1))
    if use_bake:
        hit_pack = bake['hit']
    elif collect_bake:
        hl = torch.clamp(hit_light_id, min=0).long()
        hit_pack = dict(emission=scene.light_emission[hl],
                        inv_area=scene.light_inv_area[hl],
                        pick_prob=light_ops.pick_light_prob(scene, hl))
        if has_env:
            hit_pack['env'] = light_ops.bake_env_dir(scene, term_d, time)
    else:
        hit_pack = None

    cc_mask = (s == 1) & has_lgt
    nee_mask = has_cam & (t == 1) & term_hit
    cv_mask = has_cam & (t >= 2) & term_hit

    # one occlusion query for the connect-to-camera / NEE / connect-vertex
    # terminals and the light-coordinate shadow rays: the masks are
    # exclusive by (s, t), one ray per lane
    occ_term = None
    if not frozen:
        cam_org_v, _ = tr.camera_center_dir(scene.camera, time)
        to_cam = cam_org_v - last_state.pos
        d_cc = torch.sqrt(torch.clamp(vm.length_squared(to_cam), min=1e-12))
        dir_cc = to_cam / d_cc[..., None]
        nee_out = light_ops.sample_direct(
            scene, torch.clamp(rec.cam_nee_light[lanes, c_idx], min=0),
            rec.cam_nee_lprim[lanes, c_idx], rec.cam_nee_rnd[lanes, c_idx],
            term_state.pos, time, pack=nee_pack)
        to_l = last_state.pos - term_state.pos
        d_cv = torch.sqrt(torch.clamp(vm.length_squared(to_l), min=1e-12))
        dir_cv = to_l / d_cv[..., None]
        occ_org = _where(cc_mask, last_state.pos, term_state.pos)
        occ_dir = _where(cc_mask, dir_cc,
                         _where(nee_mask, nee_out['dir_to_light'], dir_cv))
        zero = torch.zeros_like(d_cc)
        occ_max = torch.where(
            cc_mask, (1.0 - vm.SHADOW_EPS) * d_cc,
            torch.where(nee_mask, (1.0 - vm.SHADOW_EPS) * nee_out['dist'],
                        torch.where(cv_mask, (1.0 - vm.SHADOW_EPS) * d_cv,
                                    zero)))
        if lc_enabled:
            occ_org = _where(lc_fired, lc_org, occ_org)
            occ_dir = _where(lc_fired, lc_dir, occ_dir)
            occ_max = torch.where(lc_fired, lc_max, occ_max)
        occ_term = occluded_fn(occ_org, occ_dir, time, eps, occ_max)
        if lc_enabled:
            cam_ok = cam_ok & ~(lc_fired & occ_term)

    # terminal s == 1: connect the last light vertex to the camera
    cc_screen, cc_contrib, cc_ls, cc_ss, cc_mis, cc_ok = tr.connect_to_camera(
        scene, opts, occluded_fn, time, last_state, spc,
        do_occlusion=not frozen, mask=cc_mask, occ_in=occ_term)
    cc_sel = cc_mask & lgt_ok & cc_ok

    zf = torch.zeros(C, device=dev)
    out = dict(contrib=torch.zeros((C, 3), device=dev), ls=zf, ss=zf,
               mis=zf, valid=torch.zeros(C, dtype=torch.bool, device=dev))

    # terminal t == 0: the camera subpath hits a light or the env map
    is_hit_light = has_cam & (t == 0) & (
        (term_hit & (hit_light_id >= 0)) | env_case)
    h_contrib, h_ls, h_ss, h_mis, h_ok = tr.handle_hit_light(
        scene, s == 2, term_hit & ~env_case, hit_light_id, term_d, time,
        term_state, pack=hit_pack)
    out = _acc_out(out, is_hit_light & cam_ok & lgt_ok & h_ok,
                   h_contrib, h_ls, h_ss, h_mis)

    # terminal t == 1: NEE
    n_contrib, n_ls, n_ss, n_mis, n_ok = _replay_nee(
        scene, rec, c_idx, term_state, time, frozen, occluded_fn, opts,
        mask=nee_mask, occ_in=occ_term, pack=nee_pack)
    out = _acc_out(out, nee_mask & cam_ok & n_ok, n_contrib, n_ls, n_ss,
                   n_mis)

    # terminal t >= 2: connect with the last light vertex
    v_contrib, v_ls, v_ss, v_mis, v_ok = tr.connect_vertex(
        scene, opts, occluded_fn, time, last_state, term_state,
        do_occlusion=not frozen, mask=cv_mask, occ_in=occ_term)
    out = _acc_out(out, cv_mask & cam_ok & lgt_ok & v_ok, v_contrib, v_ls,
                   v_ss, v_mis)

    result = dict(
        contrib=_where(cc_sel, cc_contrib, out['contrib']),
        ls_score=torch.where(cc_sel, cc_ls, out['ls']),
        ss_score=torch.where(cc_sel, cc_ss, out['ss']),
        mis_weight=torch.where(cc_sel, cc_mis, out['mis']),
        screen_pos=_where(cc_sel, cc_screen, rec.screen_pos),
        valid=((out['valid'] | cc_sel)
               & torch.where(has_cam, cam_ok, ones_b)
               & torch.where(has_lgt, lgt_ok, ones_b)))
    if collect_bake:
        stack = lambda xs: torch.stack(xs, 1)
        bake_out = dict(
            emit=emit_pack, nee=nee_pack, hit=hit_pack,
            lgt_row=stack([x[0] for x in collected]),
            cam_row=stack([x[2] for x in collected]),
            lgt_mat=tree_map(lambda *xs: stack(xs),
                             *[x[1] for x in collected]),
            cam_mat=tree_map(lambda *xs: stack(xs),
                             *[x[3] for x in collected]))
        return rec, result, bake_out
    return rec, result


def _light_coord_step(scene, state, tri, u, time):
    """Light-coordinate sampling at a camera vertex: the direction to the
    point of light triangle `tri` at sample parameters u, with the BSDF
    throughput, MIS accumulators and ssJacobian factor the BSDF sampling
    would have given (ssJacobian * bsdfPdf / shapePdf, the generation's
    lcJacobian / SamplePdf() convention, so a zero-offset replay gives the
    generated ssScore). No occlusion here: the perturb replay's caller
    shoots the shadow ray. Returns a dict."""
    pos_l, n_l = light_ops.sample_tri(scene, tri, u, time)
    to_l = pos_l - state.pos
    d2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
    dist = torch.sqrt(d2)
    dir_l = to_l / dist[..., None]
    f, cos_l, pdf, rev_pdf = bsdf_ops.evaluate(state.mat, state.wi,
                                               state.shading_n, dir_l)
    safe_pdf = vm.clamp_abs(pdf)
    return dict(
        dir=dir_l, dist=dist, valid=torch.amax(torch.abs(f), -1) > 0.0,
        throughput=state.throughput * f / safe_pdf[..., None],
        acc_this=torch.clamp(MIS(cos_l / safe_pdf)
                             * (state.acc_this * MIS(rev_pdf)
                                + state.acc_prev), max=tr.ACC_MAX),
        acc_prev=torch.clamp(MIS(1.0 / safe_pdf), max=tr.ACC_MAX),
        ss_jacobian=state.ss_jacobian * (
            torch.abs(vm.dot(dir_l, n_l)) / d2 * pdf
            / light_ops.sample_tri_pdf(scene, tri)))


def _acc_out(out, sel, contrib, ls, ss, mis):
    return dict(contrib=_where(sel, contrib, out['contrib']),
                ls=torch.where(sel, ls, out['ls']),
                ss=torch.where(sel, ss, out['ss']),
                mis=torch.where(sel, mis, out['mis']),
                valid=out['valid'] | sel)


# ---------------------------------------------------------------------------
# derivatives of the frozen replay
# ---------------------------------------------------------------------------

def bake_frozen(scene, opts, rec):
    """Frozen-path data of a record batch: one frozen forward walk at a
    zero offset that collects every per-lane scene constant. For proposal
    records the bake comes from the perturb replay (collect_bake=True);
    this prepass is for records with no preceding replay."""
    zeros = torch.zeros((rec.time.shape[0], 2 * rec.max_depth),
                        device=rec.time.device)
    with torch.no_grad():
        _, _, bake = replay_path(scene, opts, rec, zeros, None,
                                 mode='frozen', collect_bake=True)
    return bake


def log_luminance_fn(scene, opts, rec, bake=None):
    """f(offset [C, Dm]) -> [C] log(luminance(contrib)) of the frozen
    replay."""

    def f(offset):
        _, res = replay_path(scene, opts, rec, offset, None, mode='frozen',
                             bake=bake)
        return torch.log(torch.clamp(vm.luminance(res['contrib']),
                                     min=1e-30))

    return f


def path_grad(scene, opts, rec, max_dim=None, bake=None):
    """Gradient of log-luminance w.r.t. the PSS offset [C, 2D]. Lanes are
    independent, so one backward of the summed log-luminance gives every
    lane's gradient; non-finite gradients become zero."""
    C = rec.time.shape[0]
    max_dim = 2 * rec.max_depth if max_dim is None else max_dim
    with torch.enable_grad():
        offset = torch.zeros((C, max_dim), device=rec.time.device,
                             requires_grad=True)
        f = log_luminance_fn(scene, opts, rec, bake=bake)(offset)
        (g,) = torch.autograd.grad(f.sum(), offset)
    finite = torch.isfinite(g).all(-1, keepdim=True)
    return torch.where(finite, g, torch.zeros_like(g))


def path_grad_hessian(scene, opts, rec, max_dim=None, bake=None):
    """Gradient [C, 2D] and dense Hessian [C, 2D, 2D] of log-luminance
    w.r.t. the PSS offset. Lanes are independent, so the summed
    log-luminance gives every lane's gradient g in one backward pass (with
    its graph kept), and row i of every lane's Hessian in one more backward
    pass of sum(g[:, i]): 2D passes in all. A lane whose gradient or
    Hessian is not finite gets zeros in both."""
    C = rec.time.shape[0]
    max_dim = 2 * rec.max_depth if max_dim is None else max_dim
    with torch.enable_grad():
        offset = torch.zeros((C, max_dim), device=rec.time.device,
                             requires_grad=True)
        f = log_luminance_fn(scene, opts, rec, bake=bake)(offset)
        (g,) = torch.autograd.grad(f.sum(), offset, create_graph=True)
        rows = []
        for i in range(max_dim):
            (h_i,) = torch.autograd.grad(g[:, i].sum(), offset,
                                         retain_graph=i + 1 < max_dim,
                                         allow_unused=True)
            rows.append(torch.zeros_like(offset) if h_i is None else h_i)
    g = g.detach()
    h = torch.stack(rows, 1)
    finite = (torch.isfinite(g).all(-1)
              & torch.isfinite(h).all(-1).all(-1))[:, None]
    g = torch.where(finite, g, torch.zeros_like(g))
    h = torch.where(finite[..., None], h, torch.zeros_like(h))
    return g, h
