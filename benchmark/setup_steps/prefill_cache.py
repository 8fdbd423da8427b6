"""prefill_cache: a set-up step a traffic file may name. Every seed chain
(its path record included) is pushed into the MALA run's global PSS cache
twice, so the rows of the dimensions with at least pss_max_size / 2 seed
chains are full and their chains start in the cache phase, as a long
render's chains run (a copy of chip_smoke.py's prefill_cache)."""

import dataclasses
import importlib

import torch


def run(ctx, times=2):
    prog = ctx['prog']
    cache_mod = importlib.import_module(f'{prog}.mcmc.cache')
    records = importlib.import_module(f'{prog}.path.records')
    banked, opts = ctx['banked'], ctx['opts']
    if banked.cache is None:
        raise ValueError('prefill_cache needs a MALA run\'s cache')
    st = banked.state
    C, Dm = opts.num_chains, 2 * opts.max_depth
    dev = st.ls_score.device
    zero = torch.zeros((C, Dm), device=dev)
    cache = banked.cache
    for _ in range(times):
        cache = cache_mod.push_batch(
            cache, records.pss_dim(st.rec), records.get_path_pss(st.rec, Dm),
            zero, zero, st.ls_score,
            torch.ones(C, dtype=torch.bool, device=dev), opts,
            s_tag=st.rec.cam_depth, t_tag=st.rec.lgt_depth, rec=st.rec)
    ctx['banked'] = dataclasses.replace(banked, cache=cache)
