"""MLT integrator: bootstrap, the vectorised chain step and film accumulation
(port of integrators/mlt.py for isotropic, MALA or H2MC small steps with
plain, multiplexed or cache-seeded large steps).

* bootstrap generates num_init_samples paths in wavefront chunks, takes
  the average brightness (the normalization) and the path-length
  histogram, and equal-spaced-resamples chain seeds from the
  per-contribution CDF;
* the chain step advances all chains at once: the large step runs on a
  gathered subset of the lanes that want one, the small step (isotropic,
  MALA or H2MC: small_kind) on all;
* each chain carries its current state's splat bank (a plain large-step
  state re-splats every technique of its path weighted 1 - a; a
  multiplexed or cache-seeded large-step state and a small-step state
  their single technique);
* outlier chains reset to their seed after consecutive-reject thresholds.
"""

import dataclasses
import functools

import numpy as np
import torch

from ..path import trace
from ..path.records import to_subpath, _slot_tables
from ..ops.film import splat
from ..ops.graphs import StepGraphs, commit
from ..ops import tracing
from ..mcmc import chain as chain_mod
from ..mcmc import cache as cache_mod
from ..utils.distribution import Distribution1D
from ..utils import image_io
from ..utils.tree import tree_map, tree_take
from .pathtrace import render_direct


def bootstrap(scene, opts, generator, chunk=4096):
    """Returns (b, length_dist, seed BankedState). Traced as the span
    mlt.bootstrap, each generation pass as mlt.bootstrap.pass."""
    with tracing.span('mlt.bootstrap'):
        return _bootstrap(scene, opts, generator, chunk)


def _bootstrap(scene, opts, generator, chunk):
    D = opts.max_depth
    n = opts.num_init_samples
    dev = scene.device
    min_depth = max(opts.min_depth, 3)
    recs, flats = [], []
    for start in range(0, n, chunk):
        with tracing.span('mlt.bootstrap.pass'):
            m = min(chunk, n - start)
            tape = trace.draw_tape(generator, m, D, dev)
            rec, con, _, _ = trace.generate_path_bidir(
                scene, opts, tape, min_depth=min_depth,
                max_depth=opts.max_depth)
            flat, s_tags, t_tags = con.flatten()
            recs.append(rec)
            flats.append(flat)
    ls_dev = torch.cat([f['ls_score'] for f in flats], 0)     # [n, NS]
    ls_all = ls_dev.double().cpu().numpy()

    total = float(ls_all.sum())
    b = total / n                                    # average brightness
    lengths = (s_tags + t_tags - 1).astype(np.int32)
    length_contrib = np.zeros(2 * D + 2, np.float64)
    np.add.at(length_contrib, lengths, ls_all.sum(0))

    # equal-spaced resampling over all (sample, slot) pairs; outlier seeds
    # (ls > threshold * b) are skipped up front so resets are safe
    flat_ls = ls_all.reshape(-1)
    if opts.remove_outliers:
        flat_ls = np.where(flat_ls > opts.outlier_ratio_threshold * b, 0.0,
                           flat_ls)
    cdf = np.cumsum(flat_ls)
    C = opts.num_chains
    interval = cdf[-1] / C
    u0 = float(torch.rand(1, generator=generator, device=dev).item())
    pos = u0 * interval + interval * np.arange(C)
    picks = np.minimum(np.searchsorted(cdf, pos), len(flat_ls) - 1)
    ns = ls_all.shape[1]
    sample_idx = torch.as_tensor(picks // ns, device=dev)
    slot_idx = torch.as_tensor(picks % ns, device=dev)

    rec = tree_take(tree_map(lambda *xs: torch.cat(xs, 0), *recs),
                    sample_idx)
    flat = {k: torch.cat([f[k] for f in flats], 0)[sample_idx]
            for k in flats[0]}
    rec = to_subpath(rec, torch.as_tensor(s_tags, device=dev)[slot_idx],
                     torch.as_tensor(t_tags, device=dev)[slot_idx])
    lanes = torch.arange(C, device=dev)
    take = lambda a: a[lanes, slot_idx]
    score_sum = torch.sum(flat['ls_score'], -1)
    state = init_full_state(opts, rec, take(flat['contrib']),
                            take(flat['screen_pos']), take(flat['ls_score']),
                            take(flat['ss_score']), score_sum, flat, b,
                            from_large=True)
    length_dist = Distribution1D(
        length_contrib / max(length_contrib.sum(), 1e-30), device=dev)
    return b, length_dist, state


def large_kind(opts):
    """The large-step kernel: 'cache' (cache-seeded jumps) for MALA with
    sample_from_global_cache, else 'mmlt' (multiplexed) or 'plain'."""
    if opts.sample_from_global_cache and opts.mala:
        return 'cache'
    return 'mmlt' if opts.large_step_multiplexed else 'plain'


def small_kind(opts):
    """The small-step kernel: 'h2mc', 'mala', or 'iso' (neither: the
    isotropic N(0, perturbStdDev^2) proposal alone)."""
    return 'h2mc' if opts.h2mc else 'mala' if opts.mala else 'iso'


def bank_slots(opts, D):
    """Width of the per-chain splat bank. Plain large steps: every s >= 2
    technique of a path splats at the one camera screen position, so they
    pre-sum into one point; the s == 1 techniques keep their own.
    Multiplexed and cache-seeded large steps propose one technique: one
    slot."""
    if large_kind(opts) != 'plain':
        return 1
    _, lgt_sel, _, _ = _slot_tables(D)
    return 1 + len(lgt_sel)


@functools.lru_cache(maxsize=None)
def _bank_sel(D, device):
    """The flattened techniques' positions that pre-sum into the bank's
    camera slot (s >= 2) and that keep their own (s == 1), on device, made
    once a (D, device)."""
    _, _, s_tags, _ = _slot_tables(D)
    return (torch.as_tensor(np.nonzero(s_tags >= 2)[0], device=device),
            torch.as_tensor(np.nonzero(s_tags == 1)[0], device=device))


def collapse_flat(flat, D, weight):
    """Collapse a flattened technique list [C, NS(, v)] of depth D into
    bank form; weight [C] multiplies every technique.
    Returns (screen [C, NB, 2], contrib [C, NB, 3])."""
    cam_sel, lgt_sel = _bank_sel(D, weight.device)
    ctr = (flat['contrib'] * (flat['ls_score'] > 1e-12)[..., None]
           * weight[:, None, None])
    cam_sum = ctr[:, cam_sel].sum(1)
    scr = torch.cat([flat['screen_pos'][:, cam_sel[:1]],
                     flat['screen_pos'][:, lgt_sel]], 1)
    bank = torch.cat([cam_sum[:, None], ctr[:, lgt_sel]], 1)
    return scr, bank


@dataclasses.dataclass
class BankedState:
    """ChainState + the current state's pre-weighted splat bank + the
    shared global PSS cache (None unless MALA: only MALA reads or fills
    it)."""
    state: chain_mod.ChainState
    bank_screen: torch.Tensor    # [C, NB, 2]
    bank_contrib: torch.Tensor   # [C, NB, 3] (pre-weighted)
    cache: object = None


def init_full_state(opts, rec, contrib, screen, ls, ss, score_sum, flat,
                    normalization, from_large):
    """ChainState with the splat bank filled: from_large -> every technique
    weighted norm/scoreSum, collapsed; else the single technique norm/ls."""
    C = ls.shape[0]
    D = opts.max_depth
    NB = bank_slots(opts, D)
    base = chain_mod.init_chain_state(rec, contrib, screen, ls, ss,
                                      score_sum, opts)
    if from_large and NB > 1:
        w = normalization / torch.clamp(score_sum, min=1e-12)
        bank_scr, bank_ctr = collapse_flat(flat, D, w)
    else:
        w = (normalization / torch.clamp(ls, min=1e-12))[:, None]
        bank_scr = torch.zeros((C, NB, 2), device=ls.device)
        bank_scr[:, 0] = screen
        bank_ctr = torch.zeros((C, NB, 3), device=ls.device)
        bank_ctr[:, 0] = contrib * w
    return BankedState(state=base, bank_screen=bank_scr,
                       bank_contrib=bank_ctr)


def attach_cache(banked: BankedState, opts):
    """Attach an empty global cache to a MALA run's state (with H2MC small
    steps too, as the JAX package does: only the MALA small step fills it,
    so there it stays empty). With cache sampling on it keeps the pushed
    paths as well."""
    if not opts.mala:
        return banked
    rec_proto = banked.state.rec if opts.sample_from_global_cache else None
    cache = cache_mod.make_cache(opts, 2 * opts.max_depth,
                                 banked.bank_screen.device, rec_proto)
    return dataclasses.replace(banked, cache=cache)


def make_mlt_step(scene, opts, normalization, ls_prob, length_dist=None,
                  film_shards=None):
    """The per-iteration chain update:
    step(generator, banked, film, init_banked) -> banked; the film
    [H, W, 3] is accumulated in place.

    film_shards: with S, the film is [S, H, W, 3] per-shard partial films
    and every splat point lands in its lane's shard, lane // (C // S);
    the caller sums the shards once at the end.

    Only K = ceil(1.3 * C * ls_prob) lanes run the large step per step:
    lanes wanting a large step are gathered to the front (random
    tiebreak), processed and scattered back; overflow beyond K falls back
    to a small step that iteration.

    length_dist: the bootstrap's path-length distribution, needed by the
    multiplexed and cache-seeded large steps. step.counts holds int64
    device tensors, allocated once and summed in place by every call (so
    a captured step adds at every replay; no host read): 'accepts'
    (accepted proposals, large and small), 'large' (lanes that took a
    large step) and, for multiplexed and cache-seeded steps, 'mmlt' (the
    multiplexed uniform proposals among them), 'cache' (the cache-seeded
    ones) and 'cache_accepts'.

    The step is static-shaped and reads nothing back to the host, as the
    JAX package's jitted step: make_mlt_multi_step captures it. With
    tracing on (ops/tracing) its stages are the spans mlt.large (the
    large-step lanes, their step and scatter), mlt.small (the small step),
    mlt.splat and mlt.commit (accept/reject and the state commit)."""
    C = opts.num_chains
    D = opts.max_depth
    Dm = 2 * D
    NB = bank_slots(opts, D)
    kind = large_kind(opts)
    if kind != 'plain' and length_dist is None:
        raise ValueError('multiplexed and cache-seeded large steps need the '
                         'bootstrap length distribution')
    K = min(C, max(int(C * min(ls_prob, 1.0) * 1.3) + 1, 8))
    dev = scene.device
    small = small_kind(opts)
    lane_shard = None
    if film_shards:
        if C % film_shards:
            raise ValueError(f'{C} chains do not split into {film_shards} '
                             f'film shards')
        lane_shard = torch.arange(C, device=dev) // (C // film_shards)

    keys = ['large', 'accepts'] + (['mmlt', 'cache'] if kind != 'plain'
                                   else []) \
        + (['cache_accepts'] if kind == 'cache' else [])
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in keys}

    def count(key, mask):
        counts[key].add_(mask.sum())

    def run_large(gen, state_k, cache):
        rand = lambda *s: torch.rand(s, generator=gen, device=dev)
        tape = trace.draw_tape(gen, K, D, dev)
        if kind == 'plain':
            return chain_mod.large_step(scene, opts, state_k, tape, rand(K))
        if kind == 'mmlt':
            return chain_mod.large_step_multiplexed(
                scene, opts, state_k, length_dist, tape, rand(K), rand(K))
        u_len, u_split, u_pick, u_samp = rand(K), rand(K), rand(K), rand(K)
        offset = torch.randn((K, Dm), generator=gen,
                             device=dev) * opts.cache_sig
        noise = chain_mod.perturb_noise(gen, K, D, opts, dev)
        return chain_mod.large_step_cache(
            scene, opts, state_k, length_dist, cache, tape, u_len, u_split,
            u_pick, u_samp, offset, noise)

    def step(gen, banked, film, init_banked):
        state = banked.state
        cache = banked.cache
        rand = lambda *s: torch.rand(s, generator=gen, device=dev)
        with tracing.span('mlt.large'):
            u_large = rand(C)
            want_large = (~state.valid) | (u_large < ls_prob)
            if K < C:
                sort_key = torch.where(want_large, 0.0, 2.0) + rand(C)
                sel = torch.argsort(sort_key)[:K]
            else:
                sel = torch.arange(C, device=dev)
            state_k = tree_take(state, sel)
            prop_lk, a_lk = run_large(gen, state_k, cache)
            did_large_k = want_large[sel]
            a_lk = torch.where(did_large_k, a_lk, torch.zeros_like(a_lk))
            count('large', did_large_k)
            if kind != 'plain':
                use_cache_k = prop_lk.get('use_cache',
                                          torch.zeros_like(did_large_k))
                count('mmlt', did_large_k & ~use_cache_k)
                count('cache', did_large_k & use_cache_k)

            def scat(x):
                full = torch.zeros((C,) + x.shape[1:], dtype=x.dtype,
                                   device=dev)
                full[sel] = x
                return full

            is_large = scat(did_large_k)
            a_l = scat(a_lk)
            prop_l = {k: (tree_map(scat, v) if k == 'rec' else scat(v))
                      for k, v in prop_lk.items()
                      if k not in ('all_flat', 'use_cache')}

        with tracing.span('mlt.small'):
            # the iso kind proposes from the isotropic kernel on every lane;
            # MALA's and H2MC's isotropic-mixing lanes share their single
            # replay
            use_iso = torch.ones(C, dtype=torch.bool, device=dev) \
                if small == 'iso' \
                else rand(C) < opts.uniform_mixing_probability
            z = torch.randn((C, Dm), generator=gen, device=dev)
            noise = chain_mod.perturb_noise(gen, C, D, opts, dev)
            if small == 'iso':
                prop_adv, a_small = chain_mod.small_step_iso(
                    scene, opts, state, z * opts.perturb_std_dev, noise)
            elif small == 'h2mc':
                prop_adv, a_small = chain_mod.small_step_h2mc(
                    scene, opts, state, z, noise, use_iso=use_iso,
                    skip_lanes=is_large)
            else:
                prop_adv, a_small = chain_mod.small_step_mala(
                    scene, opts, state, z, noise, cache=cache, use_iso=use_iso,
                    skip_lanes=is_large)
            a = torch.where(is_large, a_l, a_small)

        with tracing.span('mlt.splat'):
            # ---- splats: one merged index_add ----
            small_screen = prop_adv['screen']
            small_contrib = prop_adv['contrib']
            small_ls = prop_adv['ls']
            zero = torch.zeros_like(a)
            w_cur = torch.where(state.valid, 1.0 - a, zero)
            small_w = torch.where((~is_large) & (a > 0.0),
                                  a * normalization
                                  / torch.clamp(small_ls, min=1e-12), zero)
            if kind == 'plain':
                # every technique of the large proposal, collapsed
                lf = prop_lk['all_flat']
                inv_ss = 1.0 / torch.clamp(prop_lk['score_sum'], min=1e-12)
                lscr_k, lctr_k = collapse_flat(
                    lf, D,
                    torch.where(a_lk > 0.0, a_lk * normalization * inv_ss,
                                torch.zeros_like(a_lk)))
                bscr_k, bctr_k = collapse_flat(lf, D, normalization * inv_ss)
            else:
                # multiplexed / cache-seeded: the one technique of each lane
                inv_ls = normalization / torch.clamp(prop_lk['ls'], min=1e-12)
                w_k = torch.where(a_lk > 0.0, a_lk * inv_ls,
                                  torch.zeros_like(a_lk))
                lscr_k = bscr_k = prop_lk['screen'][:, None]
                lctr_k = (prop_lk['contrib'] * w_k[:, None])[:, None]
                bctr_k = (prop_lk['contrib'] * inv_ls[:, None])[:, None]
            shard_idx = None
            if lane_shard is not None:
                # the bank's NB points, the small step's one and the large
                # step's (K-compact) points per lane, each in its lane's shard
                shard_idx = torch.cat([
                    lane_shard.repeat_interleave(NB), lane_shard,
                    lane_shard[sel].repeat_interleave(lscr_k.shape[1])])
            splat(film,
                  torch.cat([banked.bank_screen.reshape(-1, 2), small_screen,
                             lscr_k.reshape(-1, 2)]),
                  torch.cat([(banked.bank_contrib
                              * w_cur[:, None, None]).reshape(-1, 3),
                             small_contrib * small_w[:, None],
                             lctr_k.reshape(-1, 3)]), shard_idx=shard_idx)
            lbank_scr = scat(bscr_k)
            lbank_ctr = scat(bctr_k)

        with tracing.span('mlt.commit'):
            # ---- accept / reject ----
            acc = (a > 0.0) & (rand(C) <= a)
            count('accepts', acc)
            if kind == 'cache':
                count('cache_accepts', acc[sel] & did_large_k & use_cache_k)
            prop_rec = chain_mod._where_state(is_large, prop_l['rec'],
                                              prop_adv['rec'])
            prop_contrib = torch.where(is_large[:, None], prop_l['contrib'],
                                       small_contrib)
            prop_screen = torch.where(is_large[:, None], prop_l['screen'],
                                      small_screen)
            prop_ls = torch.where(is_large, prop_l['ls'], small_ls)
            prop_ss = torch.where(is_large, prop_l['ss'], prop_adv['ss'])
            prop_score_sum = torch.where(is_large, prop_l['score_sum'],
                                         state.score_sum)
            acc_large = acc & is_large
            acc_small = acc & ~is_large
            acc_small_adv = acc_small & ~use_iso

            sbank_scr = torch.zeros((C, NB, 2), device=dev)
            sbank_scr[:, 0] = small_screen
            sbank_ctr = torch.zeros((C, NB, 3), device=dev)
            sbank_ctr[:, 0] = small_contrib * (
                normalization / torch.clamp(small_ls, min=1e-12))[:, None]
            al = acc_large[:, None, None]
            asm = acc_small[:, None, None]
            new_bank_scr = torch.where(al, lbank_scr, torch.where(
                asm, sbank_scr, banked.bank_screen))
            new_bank_ctr = torch.where(al, lbank_ctr, torch.where(
                asm, sbank_ctr, banked.bank_contrib))

            # the current-side Gaussian is committed only where it was really
            # evaluated (cur_ok); gaussianInitialized clears on large-step and
            # iso accepts
            ran_adv = ~is_large & ~use_iso
            if small == 'iso':
                # no Gaussian: any accept clears gaussianInitialized
                new_gauss = state.gaussian
                new_gauss_init = torch.where(acc, torch.zeros_like(acc),
                                             state.gaussian_init)
            else:
                cur_ok = prop_adv['cur_ok']
                new_gauss = chain_mod._where_gauss(
                    acc_small_adv, prop_adv['gauss_prop'],
                    chain_mod._where_gauss(ran_adv & cur_ok,
                                           prop_adv['gauss_cur'],
                                           state.gaussian))
                new_gauss_init = torch.where(
                    acc_large | (acc_small & use_iso), torch.zeros_like(acc),
                    torch.where(ran_adv, acc_small_adv | cur_ok,
                                state.gaussian_init))
            # only MALA keeps moments, snapshots and the cache
            moments = {}
            if small == 'mala':
                moments, cache = _mala_commit(state, prop_adv, cache,
                                              acc_large, acc_small_adv,
                                              ran_adv, opts)

            new_adj = torch.where(acc, torch.zeros_like(state.adjacent_reject),
                                  state.adjacent_reject + 1)
            if opts.remove_outliers:
                strong = state.ls_score > opts.outlier_ratio_threshold \
                    * normalization
                reset = ((new_adj > opts.outlier_weak_reject_cnt)
                         | (strong
                            & (new_adj > opts.outlier_strong_reject_cnt)))
            else:
                reset = torch.zeros_like(acc)

            new_state = dataclasses.replace(
                state, rec=chain_mod._where_state(acc, prop_rec, state.rec),
                valid=state.valid | acc,
                contrib=torch.where(acc[:, None], prop_contrib, state.contrib),
                screen_pos=torch.where(acc[:, None], prop_screen,
                                       state.screen_pos),
                ls_score=torch.where(acc, prop_ls, state.ls_score),
                ss_score=torch.where(acc, prop_ss, state.ss_score),
                score_sum=torch.where(acc, prop_score_sum, state.score_sum),
                stepsize=state.stepsize, gaussian=new_gauss,
                gaussian_init=new_gauss_init,
                last_score_sum=torch.where(acc_large, prop_l['score_sum'],
                                           state.last_score_sum),
                last_score=torch.where(acc_large, prop_l['ls'],
                                       state.last_score),
                adjacent_reject=new_adj, **moments)
            reset_chain = dataclasses.replace(
                init_banked.state, valid=torch.zeros_like(acc),
                gaussian_init=torch.zeros_like(acc),
                buffered=torch.zeros_like(acc))
            new_state = chain_mod._where_state(reset, reset_chain, new_state)
            rr = reset[:, None, None]
            return BankedState(
                state=new_state,
                bank_screen=torch.where(rr, init_banked.bank_screen,
                                        new_bank_scr),
                bank_contrib=torch.where(rr, init_banked.bank_contrib,
                                         new_bank_ctr),
                cache=cache)

    step.counts = counts
    return step


def _mala_commit(state, prop_adv, cache, acc_large, acc_small_adv, ran_adv,
                 opts):
    """The MALA-only part of the commit: gradient-phase moments commit on
    small accept, cache-phase lanes keep the queried moments; the chain's
    evaluation snapshot; an accepted large step pushes the chain's buffered
    snapshot into the cache. Returns (ChainState fields, cache)."""
    grad_l = prop_adv['grad_lane']
    cache_l = prop_adv['cache_lane']
    new_v1 = torch.where((acc_small_adv & grad_l)[:, None],
                         prop_adv['v1_prop'], state.v1)
    new_v1 = torch.where((ran_adv & cache_l)[:, None], prop_adv['v1_now'],
                         new_v1)
    new_v2 = torch.where((acc_small_adv & grad_l)[:, None],
                         prop_adv['v2_prop'], state.v2)
    new_v2 = torch.where((ran_adv & cache_l)[:, None], prop_adv['v2_now'],
                         new_v2)
    snap = prop_adv['snap']
    snap_sel = lambda nw, old: torch.where(
        ran_adv.reshape(ran_adv.shape + (1,) * (nw.ndim - 1)), nw, old)
    cache = cache_mod.push_batch(
        cache, 2 * (state.cached_s + state.cached_t - 1),
        state.cached_pss, state.v1, state.v2, state.cached_weight,
        acc_large & state.buffered, opts, s_tag=state.cached_s,
        t_tag=state.cached_t, rec=state.cached_rec)
    acc = acc_large | acc_small_adv
    cached_rec = state.cached_rec
    if cached_rec is not None:
        cached_rec = tree_map(snap_sel, snap['rec'], cached_rec)
    return dict(
        v1=new_v1, v2=new_v2,
        g=torch.where(acc_small_adv[:, None], prop_adv['g_prop'], state.g),
        t=state.t + acc_small_adv.to(torch.int32),
        buffered=torch.where(acc_large, torch.zeros_like(acc),
                             torch.where(acc_small_adv, torch.ones_like(acc),
                                         state.buffered)),
        queried=torch.where(ran_adv, prop_adv['queried'], state.queried),
        last_pss=torch.where(ran_adv[:, None], prop_adv['last_pss'],
                             state.last_pss),
        cached_pss=snap_sel(snap['pss'], state.cached_pss),
        cached_s=snap_sel(snap['s'], state.cached_s),
        cached_t=snap_sel(snap['t'], state.cached_t),
        cached_weight=snap_sel(snap['weight'], state.cached_weight),
        cached_rec=cached_rec), cache


def make_mlt_multi_step(scene, opts, normalization, ls_prob, n_inner,
                        length_dist=None, film_shards=None, pool=None):
    """n_inner chain iterations a call (the JAX package's fused
    multi-step): multi(generator, banked, film, init_banked) -> (banked,
    film, n_done). n_done is an int32 device tensor: the iterations of the
    call after which the summed ss_score of the chain state was finite.
    It depends on each step's output, so it proves the iterations ran,
    and a shortfall means a non-finite chain state.

    On the card, every iteration after the first of the first call is a
    CUDA graph replay. The first iteration runs eagerly on a side stream
    (the warm-up; it counts), the second is captured (ops/graphs
    StepGraphs, in the memory pool `pool`: one graph_pool_handle may be
    shared by steps that never run interleaved) and runs as captured. The
    graphs read and write static buffers, copies of the first call's
    banked, film and init_banked, and draw from the first call's
    generator (every call must pass it). The returned banked and film ARE
    those buffers: the next call overwrites them, as it would a donated
    JAX buffer. Pass them back, or other values, which are copied in. A
    capture that fails raises; nothing falls back to eager steps.

    On the CPU multi runs n_inner eager steps.

    multi.step is the eager step (make_mlt_step; its counts count every
    iteration of multi); multi.graphs the StepGraphs once captured;
    multi.warmup_s and multi.capture_pass_s the host seconds of the
    warm-up iteration and of the iteration that captures (each between
    two syncs of the device, once a multi-step; with tracing on, the
    spans mlt.warmup and graphs.capture). With tracing on a call is the
    host span mlt.call, numbered, and its state commit is in mlt.commit."""
    step = make_mlt_step(scene, opts, normalization, ls_prob,
                         length_dist=length_dist, film_shards=film_shards)
    return _MultiStep(step, scene.device, n_inner, pool)


class _MultiStep:
    """make_mlt_multi_step's multi (see there)."""

    def __init__(self, step, device, n_inner, pool):
        self.step, self.graphs = step, None
        self.warmup_s = self.capture_pass_s = 0.0
        self._device, self._n_inner, self._pool = device, n_inner, pool
        self._n_done = torch.zeros((), dtype=torch.int32, device=device)
        self._static = None

    def _body(self, gen, banked, film, init_banked):
        banked = self.step(gen, banked, film, init_banked)
        self._n_done.add_(torch.isfinite(banked.state.ss_score.sum())
                          .to(torch.int32))
        return banked

    def __call__(self, gen, banked, film, init_banked):
        with tracing.call_span():
            return self._call(gen, banked, film, init_banked)

    def _call(self, gen, banked, film, init_banked):
        self._n_done.zero_()
        if self._device.type != 'cuda':
            for _ in range(self._n_inner):
                banked = self._body(gen, banked, film, init_banked)
            return banked, film, self._n_done.clone()
        it = 0
        st = self._static
        if st is None:
            st = self._static = dict(
                banked=tree_map(torch.clone, banked), film=film.clone(),
                init=tree_map(torch.clone, init_banked), init_src=init_banked,
                gen=gen, graphs=StepGraphs(self._device, gen, self._pool))
            it = 1
        else:
            if gen is not st['gen']:
                raise ValueError('a captured multi-step draws from the '
                                 'generator of its first call')
            if banked is not st['banked']:
                commit(st['banked'], banked)
            if film is not st['film']:
                st['film'].copy_(film)
            if init_banked is not st['init_src']:
                commit(st['init'], init_banked)
                st['init_src'] = init_banked
        sb, sf, si, graphs = st['banked'], st['film'], st['init'], \
            st['graphs']

        def one():
            new = self._body(gen, sb, sf, si)
            with tracing.span('mlt.commit'):
                commit(sb, new)
        if it:
            _, self.warmup_s = tracing.timed(
                lambda: graphs.run_eager(one), self._device,
                name='mlt.warmup', stage=True)
        for _ in range(it, self._n_inner):
            if self.graphs is None:
                _, self.capture_pass_s = tracing.timed(
                    lambda: graphs.capture(one), self._device,
                    name='graphs.capture')
                self.graphs = graphs
            else:
                graphs.replay()
        return sb, sf, self._n_done.clone()


def render_mlt(scene, opts, generator, num_steps=None, progress=False,
               chunk=4096, timings=None, intermediate_path=None, n_inner=16):
    """Full MCMC render. Returns (film [H, W, 3], normalization b).

    num_steps: chain iterations (default: opts.spp * pixels / chains),
    run in calls of n_inner iterations (make_mlt_multi_step) on the JAX
    package's schedule: n_inner = min(n_inner, report interval, num_steps)
    (at least 1), num_steps rounded up to a multiple of it, the
    large-step probability switched after int(calls * ls_ratio) calls.
    timings: optional dict, filled with the seconds of each phase
    (bootstrap, direct, chain loop, snapshot writes; each ends in a device
    sync), 'steps' (the iterations run), 'n_done' (the iterations the
    multi-steps counted on the device), 'n_inner', the accepted proposals
    and the large-step lane counts of the steps (make_mlt_step's
    step.counts) and, with a cache, the rows that filled
    ('cache_rows_ready'); on the card also the captured graphs a step
    ('graphs'), the eager calls between them ('eager_calls'), the
    cond_call branches ('branches') and how often they ran and were
    skipped ('branch_runs', 'branch_skips'), their nodes
    ('graph_nodes'), the capture and instantiate seconds of every step
    ('capture_s', 'instantiate_s') and the seconds of the warm-up
    iterations ('warmup_s', 'warmups' of them) and of the iterations that
    captured ('capture_pass_s'), all inside loop_s; the other iterations
    are replays.
    intermediate_path: base path of the snapshots {path}.exr and
    {path}.png, written every report_interval_spp spp of the chain loop
    (when opts.report_interval_spp > 0) at call boundaries until the last
    call; their writes are timed apart from the chain loop
    (timings['report_s'])."""
    dev = scene.device
    timings = {} if timings is None else timings
    (b, length_dist, banked), timings['bootstrap_s'] = tracing.timed(
        lambda: bootstrap(scene, opts, generator, chunk=chunk), dev)
    normalization = b
    C = opts.num_chains
    npix = scene.width * scene.height
    if num_steps is None:
        num_steps = max(opts.spp * npix // C, 1)

    if opts.direct_spp > 0:
        direct, timings['direct_s'] = tracing.timed(
            lambda: render_direct(scene, opts, generator, chunk=chunk), dev)
    else:
        direct, timings['direct_s'] = tracing.timed(
            lambda: torch.zeros((scene.height, scene.width, 3), device=dev),
            dev)

    # two-phase large-step probability: after ls_ratio of the run it scales
    # by large_step_prob_scale (not for H2MC)
    ls_prob1 = opts.large_step_probability
    scale = 1.0 if opts.h2mc else opts.large_step_prob_scale
    ls_prob2 = min(ls_prob1 * scale, 1.0)
    report_every = 0
    if intermediate_path is not None and opts.report_interval_spp > 0:
        report_every = max(int(opts.report_interval_spp * npix / C), 1)
        n_inner = min(n_inner, report_every)
    n_inner = max(min(n_inner, num_steps), 1)
    num_steps = -(-num_steps // n_inner) * n_inner
    n_outer = num_steps // n_inner
    pool = torch.cuda.graph_pool_handle() if dev.type == 'cuda' else None
    step1 = make_mlt_multi_step(scene, opts, normalization, ls_prob1,
                                n_inner, length_dist=length_dist, pool=pool)
    step2 = step1 if ls_prob2 == ls_prob1 else \
        make_mlt_multi_step(scene, opts, normalization, ls_prob2, n_inner,
                            length_dist=length_dist, pool=pool)
    phase_switch = int(n_outer * opts.ls_ratio)
    film = torch.zeros((scene.height, scene.width, 3), device=dev)
    init_banked = banked
    banked = attach_cache(banked, opts)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    report_s = 0.0

    def report(done):
        snap = (direct + film / (done * C / npix)).cpu().numpy()
        image_io.write_image(f'{intermediate_path}.exr', snap)
        image_io.write_image(f'{intermediate_path}.png', snap)

    def loop():
        nonlocal banked, film, n_done, report_s
        for i in range(n_outer):
            step = step1 if i <= phase_switch else step2
            banked, film, nd = step(generator, banked, film, init_banked)
            n_done += nd
            if progress and i % max(n_outer // 10, 1) == 0:
                print(f'mlt step {i * n_inner}/{num_steps}', flush=True)
            done = (i + 1) * n_inner
            if report_every and done % report_every == 0 \
                    and done < num_steps:
                report_s += tracing.timed(lambda: report(done), dev)[1]
    _, loop_s = tracing.timed(loop, dev)
    timings['loop_s'] = loop_s - report_s
    timings['report_s'] = report_s
    timings.update(steps=num_steps, n_done=int(n_done), n_inner=n_inner)
    for st in {step1, step2}:
        for k, v in st.step.counts.items():
            timings[k] = timings.get(k, 0) + int(v)
    timings.update(graph_stats([step1, step2]))
    if banked.cache is not None:
        timings['cache_rows_ready'] = int(
            (banked.cache.count >= banked.cache.size).sum())
    effective_spp = num_steps * C / npix
    return direct + film / effective_spp, b


def graph_stats(multis):
    """The captured graphs of multi-steps (make_mlt_multi_step) as
    render_mlt's timings report them, from the trace registry's record of
    each StepGraphs (tracing.graph_record): graphs, eager calls between
    them (and their functions' names), cond_call branches and nodes of
    one step (the first captured); the branches' runs and skips, the
    capture and instantiate seconds, the warm-ups and their seconds and
    the seconds of the capturing iterations of all of them. Empty when
    none was captured."""
    ms = list({id(m): m for m in multis}.values())
    caught = [m.graphs for m in ms if m.graphs is not None]
    if not caught:
        return {}
    recs = [tracing.graph_record(g) for g in caught]
    first = recs[0]
    total = lambda k: sum(r[k] for r in recs)
    return dict(warmups=sum(m.warmup_s > 0 for m in ms),
                warmup_s=sum(m.warmup_s for m in ms),
                capture_pass_s=sum(m.capture_pass_s for m in ms),
                graphs=first['graphs'], eager_calls=first['eager_calls'],
                eager_fns=first['eager_fns'],
                branches=first['branches'],
                branch_runs=total('branch_runs'),
                branch_skips=total('branch_skips'),
                graph_nodes=first['nodes'], traced=first['traced'],
                capture_s=total('capture_s'),
                instantiate_s=total('instantiate_s'))
