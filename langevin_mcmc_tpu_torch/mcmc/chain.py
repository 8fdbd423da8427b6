"""Vectorised Markov-chain state and the mutation kernels: the plain,
multiplexed and cache-seeded large steps and the isotropic, MALA and H2MC
small steps (port of mcmc/chain.py).

All chains advance in lockstep as one wavefront. Random inputs are
explicit: uniform tapes and uniforms for the large steps, standard normal
draws, PSS jitters and perturb noise for the small step and the cache
replay.
"""

import dataclasses

import torch

from ..ops import tracing
from ..ops.graphs import cond_call
from ..path import trace, replay
from ..path.records import (PathRecord, to_subpath, get_path_pss, pss_dim,
                            slot_tables_on)
from ..utils.tree import tree_map, tree_take, tree_where
from . import gaussian as G
from . import cache as cache_mod

# with tracing on, the lanes of each side of a small step counted on the
# device (ops/tracing.count_lanes): MALA's lanes that needed a kNN query;
# H2MC's lanes whose Gaussian came from a Hessian, those of them that fell
# back to the isotropic Gaussian, and those whose Hessian was not finite
LANE_COUNTERS = tuple(tracing.lane_counter(n) for n in (
    'knn_need', 'h2mc_lanes', 'h2mc_fallback', 'hess_nonfinite'))
# the kNN queries' lane budgets Kq while tracing, by side
knn_budget = tracing.launch_counter(tracing.SIDES, 'knn_budget')


@dataclasses.dataclass
class ChainState:
    """Per-chain persistent state, [C]-leading."""
    rec: PathRecord
    valid: torch.Tensor          # [C] bool
    contrib: torch.Tensor        # [C,3]
    screen_pos: torch.Tensor     # [C,2]
    ls_score: torch.Tensor       # [C]
    ss_score: torch.Tensor       # [C]
    score_sum: torch.Tensor      # [C]
    v1: torch.Tensor             # [C,Dm]
    v2: torch.Tensor             # [C,Dm]
    g: torch.Tensor              # [C,Dm]
    t: torch.Tensor              # [C] int32
    buffered: torch.Tensor       # [C] bool
    stepsize: torch.Tensor       # [C]
    gaussian: G.Gaussian         # cached proposal Gaussian of the state
    gaussian_init: torch.Tensor  # [C] bool
    last_score_sum: torch.Tensor  # [C]
    last_score: torch.Tensor     # [C]
    adjacent_reject: torch.Tensor  # [C] int32
    queried: torch.Tensor        # [C] bool
    last_pss: torch.Tensor       # [C,Dm] pss of the last cache query
    # snapshot of the last MALA-evaluated state, pushed into the global
    # cache when a later large step is accepted
    cached_pss: torch.Tensor     # [C,Dm]
    cached_s: torch.Tensor       # [C] int32
    cached_t: torch.Tensor       # [C] int32
    cached_weight: torch.Tensor  # [C]
    cached_rec: object = None    # PathRecord | None (cache sampling on)


def init_chain_state(rec, contrib, screen_pos, ls, ss, score_sum, opts):
    C = ls.shape[0]
    Dm = 2 * rec.max_depth
    dev = ls.device
    z = lambda *s: torch.zeros((C,) + s, device=dev)
    zb = lambda: torch.zeros(C, dtype=torch.bool, device=dev)
    zi = lambda: torch.zeros(C, dtype=torch.int32, device=dev)
    return ChainState(
        rec=rec, valid=zb(), contrib=contrib, screen_pos=screen_pos,
        ls_score=ls, ss_score=ss, score_sum=score_sum,
        v1=z(Dm), v2=z(Dm), g=z(Dm), t=zi(), buffered=zb(),
        stepsize=torch.full((C,), opts.mala_stepsize, device=dev),
        gaussian=G.isotropic_gaussian(C, Dm, opts.perturb_std_dev, dev,
                                      dense=opts.h2mc),
        gaussian_init=zb(), last_score_sum=torch.ones(C, device=dev),
        last_score=torch.ones(C, device=dev), adjacent_reject=zi(),
        queried=zb(), last_pss=z(Dm), cached_pss=z(Dm), cached_s=zi(),
        cached_t=zi(), cached_weight=z(),
        cached_rec=tree_map(torch.zeros_like, rec)
        if opts.sample_from_global_cache else None)


def _where_state(pred, a: ChainState, b: ChainState):
    return tree_where(pred, a, b)


def _where_gauss(pred, a: G.Gaussian, b: G.Gaussian):
    return tree_where(pred, a, b)


# ---------------------------------------------------------------------------
# large step
# ---------------------------------------------------------------------------

def large_step(scene, opts, state: ChainState, tape, u_pick):
    """Fresh bidirectional path; multiple-try pick among all (s,t) by the
    contribution CDF; augmented-space acceptance.

    tape: Tape [C]; u_pick: [C] uniforms. Returns (proposal dict, a)."""
    C = state.ls_score.shape[0]
    min_depth = max(opts.min_depth, 3)
    rec, con, _, _ = trace.generate_path_bidir(
        scene, opts, tape, min_depth=min_depth, max_depth=opts.max_depth)
    flat, _, _ = con.flatten()
    ls = flat['ls_score']                      # [C, NS]
    score_sum = torch.sum(ls, -1)
    cdf = torch.cumsum(ls, -1)
    u = u_pick * score_sum
    pick = torch.sum((cdf <= u[:, None]).to(torch.int64), -1)
    pick = torch.clamp(pick, 0, ls.shape[-1] - 1)
    lanes = torch.arange(C, device=ls.device)
    take = lambda a: a[lanes, pick]
    _, _, s_tags, t_tags = slot_tables_on(opts.max_depth, ls.device)
    s_sel = s_tags[pick]
    t_sel = t_tags[pick]
    prop_ls = take(ls)
    rec_tagged = to_subpath(rec, s_sel, t_sel)

    ok = score_sum > 0.0
    prob_proposal = prop_ls / torch.clamp(score_sum, min=1e-20)
    prob_last = state.last_score / torch.clamp(state.last_score_sum,
                                               min=1e-20)
    a = torch.clamp((prop_ls * prob_last)
                    / torch.clamp(state.ls_score * prob_proposal, min=1e-20),
                    0.0, 1.0)
    a = torch.where(state.valid, a, torch.ones_like(a))
    a = torch.where(ok, a, torch.zeros_like(a))
    return dict(rec=rec_tagged, contrib=take(flat['contrib']),
                screen=take(flat['screen_pos']), ls=prop_ls,
                ss=take(flat['ss_score']), score_sum=score_sum,
                all_flat=flat, ok=ok), a


# ---------------------------------------------------------------------------
# multiplexed and cache-seeded large steps
# ---------------------------------------------------------------------------

def _sample_length(length_dist, u_len):
    """A path length from the bootstrap's length distribution."""
    return length_dist.sample_discrete(u_len)[0].to(torch.int32)


def _sample_st_split(opts, u_split, length):
    """The (s, t) split of a multiplexed large step: t uniform in
    [0, length] (bidirectional), or in {0, 1} (the unidirectional mode,
    power-2 MIS paths). Returns (s, t)."""
    if getattr(opts, 'bidirectional', True):
        t = torch.minimum((u_split * (length + 1).to(torch.float32)
                           ).to(torch.int32), length)
    else:
        t = torch.minimum((u_split * 2.0).to(torch.int32),
                          torch.clamp(length, max=1))
    t = torch.clamp(t, min=0)
    return length - t + 1, t


def _tech_inv_pmf(opts, length):
    """1 / the probability of the (s, t) split of a path of this length."""
    if getattr(opts, 'bidirectional', True):
        return (length + 1).to(torch.float32)
    return torch.full(length.shape, 2.0, device=length.device)


def large_step_multiplexed(scene, opts, state: ChainState, length_dist, tape,
                           u_len, u_split):
    """Multiplexed large step: a path length from length_dist, a uniform
    (s, t) split, that one technique generated (generate_subpath), accepted
    with the technique-pmf ratio.

    tape: Tape [C]; u_len, u_split: [C] uniforms. Returns (proposal dict,
    a)."""
    length = _sample_length(length_dist, u_len)
    s, t = _sample_st_split(opts, u_split, length)
    rec, res = trace.generate_subpath(scene, opts, tape, s, t)
    ok = res['valid']
    cur_len = state.rec.cam_depth + state.rec.lgt_depth - 1
    pmf_prop = length_dist.pmf(length.long())
    pmf_cur = length_dist.pmf(torch.clamp(cur_len, 0,
                                          length_dist.count - 1).long())
    a = torch.clamp(
        (_tech_inv_pmf(opts, length) * res['ls']
         / torch.clamp(pmf_prop, min=1e-20))
        / torch.clamp(_tech_inv_pmf(opts, cur_len) * state.ls_score
                      / torch.clamp(pmf_cur, min=1e-20), min=1e-20),
        0.0, 1.0)
    a = torch.where(state.valid, a, torch.ones_like(a))
    a = torch.where(ok, a, torch.zeros_like(a))
    return dict(rec=rec, contrib=res['contrib'], screen=res['screen'],
                ls=res['ls'], ss=res['ss'], score_sum=res['ls'], ok=ok,
                length=length), a


def _row_ready(opts, cache, dim):
    """Lanes whose PSS dimension is cached and whose row is full."""
    ndim = cache.count.shape[0]
    return ((dim >= opts.pss_min_length) & (dim <= opts.pss_max_length)
            & (cache.count[torch.clamp(dim, 0, ndim - 1).long()]
               >= cache.size))


def large_step_cache(scene, opts, state: ChainState, length_dist, cache,
                     tape, u_len, u_split, u_pick, u_samp, offset, noise):
    """Cache-seeded large step: a path length from length_dist; where that
    dimension's row is full, with probability cache_prob the proposal is a
    stored path (drawn by path weight) replayed with a wrapped Gaussian
    jitter, else the multiplexed uniform proposal. The acceptance uses the
    MIS blend of the cache's KDE pdf and the uniform technique pdf.

    tape: Tape [C] of the uniform branch; u_len, u_split, u_pick, u_samp:
    [C] uniforms (length, split, branch pick, cache draw); offset: [C, Dm]
    PSS jitter (N(0, cache_sig^2)); noise: the perturb jitters of the
    replay (perturb_noise). Both branches run on every lane and each lane
    takes its own, as in the JAX package (no lane's result depends on the
    other branch).
    Returns (proposal dict with 'use_cache', a)."""
    Dm = 2 * opts.max_depth
    length = _sample_length(length_dist, u_len)
    prop_dim = 2 * length
    prop_avail = _row_ready(opts, cache, prop_dim)
    use_cache = prop_avail & (u_pick <= opts.cache_prob)

    # uniform multiplexed branch
    s, t = _sample_st_split(opts, u_split, length)
    rec_u, res_u = trace.generate_subpath(scene, opts, tape, s, t)
    # cache branch: a stored path, replayed with a wrapped Gaussian jitter
    _, _, _, rec_stored = cache_mod.sample_cache(cache, prop_dim, u_samp)
    rec_c, res_c = replay.replay_path(scene, opts, rec_stored, offset, noise,
                                      mode='perturb')

    def sel(c_val, u_val):
        m = use_cache.reshape(use_cache.shape + (1,) * (c_val.ndim - 1))
        return torch.where(m, c_val, u_val)
    prop = dict(rec=tree_where(use_cache, rec_c, rec_u),
                contrib=sel(res_c['contrib'], res_u['contrib']),
                screen=sel(res_c['screen_pos'], res_u['screen']),
                ls=sel(res_c['ls_score'], res_u['ls']),
                ss=sel(res_c['ss_score'], res_u['ss']),
                ok=torch.where(use_cache, res_c['valid']
                               & (res_c['ss_score'] > 0.0), res_u['valid']))

    # MIS acceptance
    cur_len = state.rec.cam_depth + state.rec.lgt_depth - 1
    cur_dim = 2 * cur_len
    cur_avail = _row_ready(opts, cache, cur_dim)
    prop_jac = prop['ss'] / torch.clamp(prop['ls'], min=1e-20)
    cur_jac = state.ss_score / torch.clamp(state.ls_score, min=1e-20)
    prop_uni = 1.0 / (length + 1).to(torch.float32) * prop_jac
    cur_uni = 1.0 / torch.clamp((cur_len + 1).to(torch.float32),
                                min=1.0) * cur_jac

    def kde(avail, dim, r):
        """eval_pdf_cache on every lane, 0 where the row is not full."""
        pdf = cache_mod.eval_pdf_cache(cache, dim, get_path_pss(r, Dm),
                                       r.cam_depth, r.lgt_depth, opts)
        return torch.where(avail, pdf, torch.zeros_like(pdf))

    cp = opts.cache_prob
    prop_pdf = torch.where(prop_avail, (1 - cp) * prop_uni
                           + cp * kde(prop_avail, prop_dim, prop['rec']),
                           prop_uni)
    cur_pdf = torch.where(cur_avail, (1 - cp) * cur_uni
                          + cp * kde(cur_avail, cur_dim, state.rec), cur_uni)
    pmf_prop = length_dist.pmf(length.long())
    pmf_cur = length_dist.pmf(torch.clamp(cur_len, 0,
                                          length_dist.count - 1).long())
    a = torch.clamp(
        (prop['ss'] * cur_pdf * pmf_cur)
        / torch.clamp(state.ss_score * prop_pdf * pmf_prop, min=1e-30),
        0.0, 1.0)
    a = torch.where(state.valid, a, torch.ones_like(a))
    a = torch.where(prop['ok'], a, torch.zeros_like(a))
    return dict(prop, score_sum=prop['ls'], length=length,
                use_cache=use_cache), a


# ---------------------------------------------------------------------------
# small steps
# ---------------------------------------------------------------------------

def perturb_noise(generator, C, D, opts, device):
    """Gaussian jitters of time and the discrete randoms."""
    sd = opts.discrete_std_dev
    n = lambda *s: torch.randn(s, generator=generator, device=device) * sd
    return dict(time=n(C), cam_disc=n(C, D), lgt_disc=n(C, D))


def small_step_iso(scene, opts, state: ChainState, offset, noise):
    """Isotropic small step: the perturb replay at offset [C, Dm] (the
    N(0, perturbStdDev^2) draw, already scaled) with the perturb jitters
    noise (perturb_noise); the MH ratio is the ssScore ratio.
    Returns (proposal dict, a)."""
    with tracing.span('chain.replay'):
        new_rec, res = replay.replay_path(scene, opts, state.rec, offset,
                                          noise, mode='perturb')
    ok = res['valid'] & (res['ss_score'] > 0.0)
    a = torch.clamp(res['ss_score'] / torch.clamp(state.ss_score, min=1e-20),
                    0.0, 1.0)
    a = torch.where(ok, a, torch.zeros_like(a))
    return dict(rec=new_rec, contrib=res['contrib'], screen=res['screen_pos'],
                ls=res['ls_score'], ss=res['ss_score'], ok=ok), a


def _bake(scene, opts, rec):
    """The frozen-path bake of rec on a static scene; None on a moving one,
    whose frozen replay lerps each triangle at the record's time."""
    return None if scene.has_motion else replay.bake_frozen(scene, opts, rec)


def _perturb_and_grad(scene, opts, rec, offset, noise, grad_mask=None,
                      want_hess=False):
    """Perturb replay (collecting the frozen-path bake on a static scene) +
    the gradient at the proposal (and its dense Hessian when want_hess:
    H2MC, whose every lane consumes both). grad_mask [C] bool: the lanes
    that consume the gradient; where none does it is zeros, as the JAX
    package's lax.cond gives (ops/graphs.cond_call: selected on the
    device, and skipped by a captured step).
    Returns (new_rec, res, grad [C, Dm], None or, when want_hess, (hess
    [C, Dm, Dm], the lanes whose gradient and Hessian were finite [C])).
    Traced as the spans chain.replay and chain.grad."""
    with tracing.span('chain.replay'):
        if scene.has_motion:
            new_rec, res = replay.replay_path(scene, opts, rec, offset,
                                              noise, mode='perturb')
            bake = None
        else:
            new_rec, res, bake = replay.replay_path(
                scene, opts, rec, offset, noise, mode='perturb',
                collect_bake=True)
    with tracing.span('chain.grad'):
        if want_hess:
            grad, hess, finite = replay.path_grad_hessian(
                scene, opts, new_rec, bake=bake, side='prop')
            return new_rec, res, grad, (hess, finite)
        grad = cond_call(grad_mask.any(),
                         lambda r, b: replay.path_grad(scene, opts, r,
                                                       bake=b),
                         new_rec, bake)
    return new_rec, res, grad, None


def _mala_iso(C, Dm, opts, device):
    """IsotropicGaussian(dim, malaStdDev)."""
    return G.isotropic_gaussian(C, Dm, opts.mala_std_dev, device)


def small_step_mala(scene, opts, state: ChainState, z, noise, cache,
                    use_iso=None, skip_lanes=None):
    """MALA small step, gradient and cache phases.

    z: [C, Dm] standard-normal draws of the proposal offset; noise: the
    perturb jitters (perturb_noise); cache: the global PSS cache (MALA
    always reads and fills one). use_iso: lanes proposing from the
    isotropic N(0, perturbStdDev^2) kernel instead (they share this step's
    one replay). skip_lanes: lanes whose result the caller discards (the
    large-step lanes), excluded from the sparse current-side budget.

    Gradient phase (the lane's dimension row of the cache is not full):
    the current-side gradient runs only where the cached Gaussian is stale,
    on a gathered subset of cur_grad_fraction * C lanes; lanes beyond the
    budget propose from the isotropic N(0, malaStdDev^2) kernel once, and
    the MH ratio uses the kernel actually sampled. Cache phase (row full):
    moments are kNN-interpolated from the cache, re-querying only lanes
    that moved beyond pss_reuse_dist of their last query, on a budget of
    cache_query_fraction * C lanes."""
    C = state.ls_score.shape[0]
    D = opts.max_depth
    Dm = 2 * D
    dev = state.ls_score.device

    dim = pss_dim(state.rec)
    in_range = (dim >= opts.pss_min_length) & (dim <= opts.pss_max_length)
    ready = cache.count[torch.clamp(dim, 0, cache.count.shape[0] - 1)
                        .long()] >= cache.size
    grad_lane = in_range & ~ready
    cache_lane = in_range & ready
    iso = _mala_iso(C, Dm, opts, dev)

    def ema_moments(grad, v1_in, v2_in, ss_score):
        """Truncated-drift EMA + preconditioner."""
        grad = torch.where((ss_score > 1e-10)[:, None], grad,
                           torch.zeros_like(grad))
        norm = torch.sqrt(torch.sum(torch.square(grad), -1, keepdim=True))
        grad = grad * (opts.mala_gn / torch.clamp(norm, min=opts.mala_gn))
        first = ~torch.any(v2_in > 1e-10, -1)
        f = first[:, None]
        v1 = torch.where(f, grad, 0.9 * v1_in + 0.1 * grad)
        v2 = torch.where(f, grad * grad, 0.999 * v2_in + 0.001 * grad * grad)
        M = torch.clamp(1.0 / (1e-3 + torch.sqrt(torch.clamp(v2, min=0.0))),
                        opts.pcd_min, opts.pcd_max)
        return grad, v1, v2, M

    cur_need = grad_lane & ~state.gaussian_init
    if use_iso is not None:
        cur_need &= ~use_iso
    if skip_lanes is not None:
        cur_need &= ~skip_lanes

    def grad_with_bake(r):
        return replay.path_grad(scene, opts, r, bake=_bake(scene, opts, r))

    def sparse_cur_grad():
        Kc = min(C, max(int(C * opts.cur_grad_fraction), 8))
        # with no lane in need this gives zeros and no lane covered, what
        # the JAX package's lax.cond gives
        zeros = torch.zeros((C, Dm), device=dev)
        flag = cur_need.any()
        if Kc >= C:
            with tracing.span('chain.grad'):
                grad = cond_call(flag, grad_with_bake, state.rec)
            return torch.where(cur_need[:, None], grad, zeros), cur_need
        order = torch.argsort(torch.where(cur_need, 0, 1), stable=True)
        sel = order[:Kc]
        grad = zeros.clone()
        with tracing.span('chain.grad'):
            grad[sel] = cond_call(flag, grad_with_bake,
                                  tree_take(state.rec, sel))
        covered = torch.zeros_like(cur_need).index_fill_(0, sel, True)
        covered &= cur_need
        return torch.where(covered[:, None], grad, zeros), covered

    def cache_gauss(side, *args):
        """The kNN moments of side 'cur' or 'prop', traced as the span
        cache.knn."""
        with tracing.span('cache.knn'):
            return knn_gauss(side, *args)

    def knn_gauss(side, pss_q, ss_score, v1_in, v2_in, queried, last_pss,
                  need_mask):
        """kNN query (or reuse of the last query) for need_mask lanes.
        Returns (gauss, v1, v2, queried, last_pss)."""
        dmask = (torch.arange(Dm, device=dev)[None] < dim[:, None]).float()
        dist_sq = torch.sum(torch.square((pss_q - last_pss) * dmask), -1)
        reuse = queried & (dist_sq < dim.float() * opts.pss_reuse_dist ** 2)
        need_q = need_mask & ~reuse
        Kq = min(C, max(int(C * opts.cache_query_fraction), 8))
        if tracing.count_lanes('knn_need', side, need_q):
            knn_budget[side] += Kq
        if Kq >= C:
            found, qv1, qv2 = cache_mod.query_knn(cache, dim, pss_q, opts)
        else:
            order = torch.argsort(torch.where(need_q, 0, 1), stable=True)
            sel = order[:Kq]
            f_s, v1_s, v2_s = cache_mod.query_knn(cache, dim[sel], pss_q[sel],
                                                  opts)
            found = torch.zeros(C, dtype=torch.bool, device=dev)
            found[sel] = f_s
            qv1 = torch.zeros((C, Dm), device=dev)
            qv1[sel] = v1_s
            qv2 = torch.zeros((C, Dm), device=dev)
            qv2[sel] = v2_s
        found = found & need_q
        v1 = torch.where(reuse[:, None], v1_in, qv1)
        v2 = torch.where(reuse[:, None], v2_in, qv2)
        hit = reuse | found
        v1 = torch.where(hit[:, None], v1, v1_in)
        v2 = torch.where(hit[:, None], v2, v2_in)
        new_queried = queried | found
        new_last = torch.where((found & ~reuse)[:, None], pss_q, last_pss)
        M = torch.clamp(1.0 / (1e-3 + torch.sqrt(torch.clamp(v2, min=0.0))),
                        opts.pcd_min, opts.pcd_max)
        g_hit = G.mala_gaussian(v1, v2, state.stepsize, opts.mala_std_dev,
                                M, ss_score, opts)
        return _where_gauss(hit, g_hit, iso), v1, v2, new_queried, new_last

    # ---- current state (only where the Gaussian is not cached) ----
    pss_cur = get_path_pss(state.rec, Dm)
    g_cur, cur_covered = sparse_cur_grad()
    # grad-phase lanes beyond the sparse budget proposed from the isotropic
    # fallback; the caller must not commit it as the cached Gaussian
    cur_ok = ~(cur_need & ~cur_covered)
    _, v1_cur, v2_cur, M_cur = ema_moments(g_cur, state.v1, state.v2,
                                           state.ss_score)
    gauss_grad_cur = G.mala_gaussian(v1_cur, v2_cur, state.stepsize,
                                     opts.mala_std_dev, M_cur,
                                     state.ss_score, opts)
    # the cache queries run on every call and are selected on the device
    # by whether any lane needs them (the JAX package's lax.conds)
    need = cache_lane & ~state.gaussian_init
    gauss_cache_cur, cv1, cv2, queried1, last_pss1 = tree_where(
        need.any(),
        cache_gauss('cur', pss_cur, state.ss_score, state.v1, state.v2,
                    state.queried, state.last_pss, need),
        (iso, state.v1, state.v2, state.queried, state.last_pss))
    upd = need[:, None]
    v1_now = torch.where(upd, cv1, state.v1)
    v2_now = torch.where(upd, cv2, state.v2)
    queried1 = torch.where(need, queried1, state.queried)
    last_pss1 = torch.where(upd, last_pss1, state.last_pss)
    gauss_cur_new = _where_gauss(
        cache_lane, gauss_cache_cur,
        _where_gauss(cur_covered, gauss_grad_cur, iso))
    gauss_cur = _where_gauss(state.gaussian_init, state.gaussian,
                             gauss_cur_new)
    if use_iso is not None:
        iso_g = G.isotropic_gaussian(C, Dm, opts.perturb_std_dev, dev)
        gauss_cur = _where_gauss(use_iso, iso_g, gauss_cur)

    offset = G.gaussian_sample(gauss_cur, z)
    new_rec, res, g_raw, _ = _perturb_and_grad(scene, opts, state.rec,
                                               offset, noise, grad_lane)
    ok = res['valid'] & (res['ss_score'] > 0.0)

    # ---- proposal state ----
    pss_prop = get_path_pss(new_rec, Dm)
    g_prop, v1_prop, v2_prop, M_prop = ema_moments(g_raw, v1_now, v2_now,
                                                   res['ss_score'])
    gauss_grad_prop = G.mala_gaussian(v1_prop, v2_prop, state.stepsize,
                                      opts.mala_std_dev, M_prop,
                                      res['ss_score'], opts)
    need = cache_lane & ok
    gauss_cache_prop, pv1, pv2, queried2, last_pss2 = tree_where(
        cache_lane.any(),
        cache_gauss('prop', pss_prop, res['ss_score'], v1_now, v2_now,
                    queried1, last_pss1, need),
        (iso, v1_now, v2_now, queried1, last_pss1))
    upd = need[:, None]
    v1_now = torch.where(upd, pv1, v1_now)
    v2_now = torch.where(upd, pv2, v2_now)
    queried2 = torch.where(need, queried2, queried1)
    last_pss2 = torch.where(upd, last_pss2, last_pss1)
    gauss_prop = _where_gauss(cache_lane, gauss_cache_prop,
                              _where_gauss(grad_lane, gauss_grad_prop, iso))
    if use_iso is not None:
        gauss_prop = _where_gauss(use_iso, iso_g, gauss_prop)

    py = G.gaussian_log_pdf(offset, gauss_cur)
    px = G.gaussian_log_pdf(-offset, gauss_prop)
    a = torch.clamp(torch.exp(px - py) * res['ss_score']
                    / torch.clamp(state.ss_score, min=1e-20), 0.0, 1.0)
    a = torch.where(ok, a, torch.zeros_like(a))

    # chain snapshot for later cache pushes: the proposal evaluation wins
    # when it ran, else the current side where it was actually evaluated
    evald_cur = cur_covered | (cache_lane & ~state.gaussian_init)

    def snap_sel(p, c, o):
        shape = ok.shape + (1,) * (p.ndim - 1)
        return torch.where(ok.reshape(shape), p,
                           torch.where(evald_cur.reshape(shape), c, o))

    snap = dict(
        pss=snap_sel(pss_prop, pss_cur, state.cached_pss),
        s=snap_sel(new_rec.cam_depth, state.rec.cam_depth, state.cached_s),
        t=snap_sel(new_rec.lgt_depth, state.rec.lgt_depth, state.cached_t),
        weight=snap_sel(res['ls_score'], state.ls_score,
                        state.cached_weight))
    if state.cached_rec is not None:
        snap['rec'] = tree_map(snap_sel, new_rec, state.rec,
                               state.cached_rec)
    return dict(rec=new_rec, contrib=res['contrib'], screen=res['screen_pos'],
                ls=res['ls_score'], ss=res['ss_score'], ok=ok,
                gauss_cur=gauss_cur, gauss_prop=gauss_prop, cur_ok=cur_ok,
                v1_prop=v1_prop, v2_prop=v2_prop, g_prop=g_prop,
                v1_now=v1_now, v2_now=v2_now, grad_lane=grad_lane,
                cache_lane=cache_lane, queried=queried2, last_pss=last_pss2,
                snap=snap), a


# ---------------------------------------------------------------------------
# H2MC small step
# ---------------------------------------------------------------------------

def small_step_h2mc(scene, opts, state: ChainState, z, noise, use_iso=None,
                    skip_lanes=None):
    """H2MC small step: gradient + Hessian at the current state and at the
    proposal, anisotropic Gaussians, full MH ratio.

    z: [C, Dm] standard-normal draws of the proposal offset; noise: the
    perturb jitters (perturb_noise). use_iso: lanes proposing from the
    isotropic N(0, perturbStdDev^2) kernel instead (they share this step's
    one replay). skip_lanes: lanes whose result the caller discards (the
    large-step lanes), excluded from the current-side budget.

    The current-side gradient + Hessian runs only where the cached Gaussian
    is stale, on a gathered subset of cur_grad_fraction * C lanes; lanes
    beyond the budget propose from the isotropic kernel once, and the MH
    ratio uses the kernel actually sampled (cur_ok tells the caller not
    to commit it).

    With tracing on, each side counts its lanes (the lane counters
    h2mc_lanes, h2mc_fallback and hess_nonfinite): on
    the current side the lanes in need that the budget covered, on the
    proposal side the valid proposals of the lanes that neither mix nor
    take a large step."""
    C = state.ls_score.shape[0]
    Dm = 2 * opts.max_depth
    dev = state.ls_score.device
    sigma = opts.perturb_std_dev

    def h2mc_gauss(side, grad, hess, finite, ss_score, used):
        """The Gaussians of one side; used() gives the lanes that take
        them, for the counters (run only while tracing)."""
        m = (ss_score > 1e-15)[:, None]
        grad = torch.where(m, grad, torch.zeros_like(grad))
        hess = torch.where(m[..., None], hess, torch.zeros_like(hess))
        gauss, fallback = G.h2mc_gaussian(grad, hess, sigma, ss_score)
        if tracing.enabled():
            lanes = used()
            tracing.count_lanes('h2mc_lanes', side, lanes)
            tracing.count_lanes('h2mc_fallback', side, lanes & fallback)
            tracing.count_lanes('hess_nonfinite', side, lanes & ~finite)
        return gauss

    need = ~state.gaussian_init
    if use_iso is not None:
        need &= ~use_iso
    if skip_lanes is not None:
        need &= ~skip_lanes
    Kc = min(C, max(int(C * opts.cur_grad_fraction), 8))
    iso = G.isotropic_gaussian(C, Dm, sigma, dev, dense=True)
    # computed on every call and selected on the device by whether any
    # lane needs it (the JAX package's lax.cond)
    if Kc >= C:
        sel = torch.arange(C, device=dev)
    else:
        sel = torch.argsort(torch.where(need, 0, 1), stable=True)[:Kc]
    rec_sel = tree_take(state.rec, sel)
    with tracing.span('chain.grad'):
        grad, hess, finite = replay.path_grad_hessian(
            scene, opts, rec_sel, bake=_bake(scene, opts, rec_sel),
            side='cur')
    gauss_sel = h2mc_gauss('cur', grad, hess, finite, state.ss_score[sel],
                           lambda: need[sel])

    def put(s, d):
        d = d.clone()
        d[sel] = s
        return d

    any_need = need.any()
    gauss_cur_new = tree_where(any_need, tree_map(put, gauss_sel, iso), iso)
    covered = torch.zeros_like(need).index_fill_(0, sel, True)
    covered &= need
    gauss_cur_new = _where_gauss(covered, gauss_cur_new, iso)
    cur_ok = ~(need & ~covered)
    gauss_cur = _where_gauss(state.gaussian_init, state.gaussian,
                             gauss_cur_new)
    if use_iso is not None:
        gauss_cur = _where_gauss(use_iso, iso, gauss_cur)

    offset = G.gaussian_sample(gauss_cur, z)
    new_rec, res, g_p, (h_p, finite_p) = _perturb_and_grad(
        scene, opts, state.rec, offset, noise, want_hess=True)
    ok = res['valid'] & (res['ss_score'] > 0.0)

    def prop_used():
        used = ok
        for lanes in (use_iso, skip_lanes):
            if lanes is not None:
                used = used & ~lanes
        return used
    gauss_prop = h2mc_gauss('prop', g_p, h_p, finite_p, res['ss_score'],
                            prop_used)
    if use_iso is not None:
        gauss_prop = _where_gauss(use_iso, iso, gauss_prop)
    py = G.gaussian_log_pdf(offset, gauss_cur)
    px = G.gaussian_log_pdf(-offset, gauss_prop)
    a = torch.clamp(torch.exp(px - py) * res['ss_score']
                    / torch.clamp(state.ss_score, min=1e-20), 0.0, 1.0)
    a = torch.where(ok, a, torch.zeros_like(a))
    return dict(rec=new_rec, contrib=res['contrib'], screen=res['screen_pos'],
                ls=res['ls_score'], ss=res['ss_score'], ok=ok,
                gauss_cur=gauss_cur, gauss_prop=gauss_prop, cur_ok=cur_ok), a
