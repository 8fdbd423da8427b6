"""The check of H2MC's proposals, beside check.py's (which holds the
paths, the film and the acceptance). check.py does not call these
helpers: no run's `correct` reads gauss_mismatch or mh_mismatch yet
(`benchmark/tests/test_bench_h2mc.py` runs them on the card; a later
harness calls them from check.take and check.judge).

* take_gauss() copies, after a run, a sample of chains drawn from the
  seed among those whose gaussian_init is set (their stored Gaussian is
  the one of their current path record): each chain's path record, its
  ss_score and the stored Gaussian's mean, inv_cov and log_det, with the
  prior sigma.
* take_mh() has the program take one more H2MC small step of those
  chains (draws of its own from the seed; the run's state is left as it
  is) and copies each chain's proposal record, the offset proposed and
  the acceptance probability the program computed. Then the program's
  state can be freed.
* reference_gauss() has the plain reference (lmcref, in its dtype) take
  each sampled record's gradient and Hessian again, by another method
  than the program's (lmcref.mcmc.h2mc.grad_hessian), and form the
  Gaussian from them in float64 (lmcref.mcmc.h2mc.gaussian, dpt's
  closed form); judge_gauss() compares the two.
* reference_mh() does the same at each proposal and forms the MH
  acceptance probability of mutation_h2mc.h in float64 from the
  reference's Gaussians and scores; judge_mh() compares it with the
  program's.

gauss_mismatch is the share of the sampled chains whose stored Gaussian
lies past any of these tolerances from the reference's (or is not
finite):

* INV_COV_RTOL on inv_cov, the Frobenius norm of the difference over the
  reference's. inv_cov = V diag(|lambda| / s^2 + 1 / sigma^2) V^T is a
  smooth function of the Hessian away from a sign change of an
  eigenvalue near 0, where the 1e4 prior dominates; the program computes
  the Hessian's rows by float32 second-order autodiff of a replay that
  reads a bake and decomposes it in float32 (cuSOLVER), so it lies up
  to some 5e-4 from the float64 closed form on the reference's float32
  Hessian (the widest of 2,560 chains on an H100). A Hessian computed in
  bfloat16, or one with a part left out, lies 1e-1 or more away.
* MEAN_TOL on the mean, as the distance of the two means in standard
  deviations of the reference's Gaussian, sqrt(dm^T inv_cov dm): what a
  shifted mean does to the proposal. The mean's scale is the gradient's
  over the curvature, and its rounding follows the Hessian's (at most
  some 2e-3 on an H100).
* LOG_DET_TOL on log_det, absolute: log_det enters the MH ratio as
  exp(0.5 dlog_det); a sum of 2D logs near log(1e4) rounds to some 1e-5
  in float32 (at most 5e-4 on an H100, with the Hessian's rounding),
  and a Hessian off by 1e-2 moves it by 1e-2 or more.

A lane that falls back to the isotropic Gaussian on one side and not the
other lies far past all three.

mh_mismatch is the share of the sampled chains whose acceptance
probability lies more than MH_TOL from the reference's (or is not
finite). The probability is min(1, exp(log q(x | y) - log q(y | x))
ss(y) / ss(x)): the Gaussians' rounding above moves the log-ratio by
some 1e-2 where the quadratic forms are of the order of the dimension,
and the scores follow the replay (1e-3, check.PATH_RTOL), so a sound
chain's probability lies within a few 1e-3 of the reference's; a ratio
that leaves out the densities, or takes them from other Gaussians, moves
every chain with an anisotropic Gaussian on either side by 1e-1 or more.
Where both sides are isotropic the densities cancel, so such faults
move only the 10-20% of the chains that are not.

Each share's limit (GAUSS_LIMIT, MH_LIMIT) lies between the sound runs'
readings (0) and those of the faults and the control, which is the
reference in bfloat16 put in the program's place (PERF.md section 2).
"""

import importlib
import multiprocessing

import numpy as np
import torch

from . import check
from .cell import PROG

N_GAUSS = 512          # chains the Gaussian check samples
INV_COV_RTOL = 1e-3
MEAN_TOL = 1e-2
LOG_DET_TOL = 1e-2
MH_TOL = 2e-2
# the shares of the sampled chains past a tolerance that a sound run stays
# at or below
GAUSS_LIMIT = 0.02
MH_LIMIT = 0.01


def take_gauss(seed, banked, opts, n=N_GAUSS):
    """The stored H2MC Gaussians of a seeded sample of n chains whose
    gaussian_init is set, copied to the host."""
    st = banked.state
    elig = torch.nonzero(st.gaussian_init & st.valid)[:, 0].cpu().numpy()
    pick = np.sort(check._rng(seed, 4).choice(elig, min(n, len(elig)),
                                              replace=False))
    it = torch.as_tensor(pick, dtype=torch.long, device=st.ss_score.device)
    g = st.gaussian
    return dict(chains=int(st.ss_score.shape[0]), eligible=int(len(elig)),
                idx=pick, rec=check._rec_dict(st.rec, it),
                ss=st.ss_score[it].cpu(), mean=g.mean[it].cpu(),
                inv_cov=g.inv_cov[it].cpu(), log_det=g.log_det[it].cpu(),
                sigma=float(opts.perturb_std_dev))


def take_mh(seed, sample, banked, scene, opts):
    """One more H2MC small step (the program's small_step_h2mc, every
    lane proposing from its H2MC Gaussian) of take_gauss's sampled
    chains, with draws of its own from the seed: the proposal records,
    the offsets and the program's acceptance probabilities, copied to the
    host."""
    chain = importlib.import_module(f'{PROG}.mcmc.chain')
    G = importlib.import_module(f'{PROG}.mcmc.gaussian')
    tree = importlib.import_module(f'{PROG}.utils.tree')
    st = banked.state
    dev = st.ss_score.device
    it = torch.as_tensor(sample['idx'], dtype=torch.long, device=dev)
    sub = tree.tree_take(st, it)
    n, D = len(sample['idx']), opts.max_depth
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(check._rng(seed, 5).integers(2 ** 62)))
    z = torch.randn((n, 2 * D), generator=gen, device=dev)
    noise = chain.perturb_noise(gen, n, D, opts, dev)
    with torch.no_grad():
        prop, a = chain.small_step_h2mc(scene, opts, sub, z, noise)
        offset = G.gaussian_sample(prop['gauss_cur'], z)
    every = torch.arange(n, device=dev)
    return dict(rec=check._rec_dict(prop['rec'], every), offset=offset.cpu(),
                a=a.cpu(), ok=prop['ok'].cpu())


def _lanes(xml, dtype, fields, block):
    """The reference's gradient, Hessian, finite lanes, ss_score and
    valid lanes of records (fields: a rec dict of take_gauss or take_mh),
    on the host in dtype."""
    from lmcref.mcmc import h2mc
    from lmcref.path.records import PathRecord
    ref = check.Reference(xml, 'cpu', dtype)
    n = fields['time'].shape[0]
    rec = check._ref_record(PathRecord, fields, slice(0, n), ref.device,
                            ref.dtype)
    with ref._precision():
        return h2mc.grad_hessian(ref.scene, ref.opts, rec, block=block) \
            + h2mc.scores(ref.scene, ref.opts, rec)


def _reference_lanes(fields, xml, dtype, workers):
    """_lanes over the records, split over `workers` processes: the
    reference's vectorised functional.hessian falls back to a loop over
    the rows for many of the double backward's operations, which on a
    card is a launch each (a few seconds a lane), on the host well under
    a second."""
    from lmcref.mcmc import h2mc
    n = fields['time'].shape[0]
    parts = [p for p in np.array_split(np.arange(n), max(workers, 1))
             if len(p)]
    args = [(xml, dtype, {k: v[p] for k, v in fields.items()}, h2mc.BLOCK)
            for p in parts]
    if len(args) > 1:
        ctx = multiprocessing.get_context('spawn')
        with ctx.Pool(len(args), initializer=torch.set_num_threads,
                      initargs=(1,)) as pool:
            res = pool.starmap(_lanes, args)
    else:
        res = [_lanes(*a) for a in args]
    return [torch.cat([r[k] for r in res]) for k in range(5)]


def reference_gauss(sample, xml, dtype=torch.float32, workers=1):
    """The reference's Gaussians of the sampled records (float64, host):
    the reference parses the scene files xml itself, takes each record's
    gradient and Hessian in dtype and forms the closed form in float64
    (on the program's stored ss_score, as the program does). Also its
    score of each record ('ss')."""
    from lmcref.mcmc import h2mc
    g, h, finite, ss, _ = _reference_lanes(sample['rec'], xml, dtype,
                                           workers)
    out = h2mc.gaussian(g, h, sample['sigma'], sample['ss'])
    out.update(nonfinite=~finite, ss=ss.double())
    return out


def reference_mh(sample, mh, want, xml, dtype=torch.float32, workers=1):
    """The reference's MH acceptance probabilities [n] (float64, host) of
    take_mh's proposals: its Gaussian at each proposal (as
    reference_gauss, on its own score of the proposal) and want's (a
    reference_gauss of the sample) at each current record, the densities
    of the offset and its reverse under them, and its scores of both
    records."""
    from lmcref.mcmc import h2mc
    g, h, _, ss_y, valid = _reference_lanes(mh['rec'], xml, dtype, workers)
    ss_y = ss_y.double()
    gy = h2mc.gaussian(g, h, sample['sigma'], ss_y)
    off = mh['offset'].double()
    log_ratio = h2mc.log_pdf(-off, gy) - h2mc.log_pdf(off, want)
    a = torch.clamp(torch.exp(log_ratio) * ss_y
                    / torch.clamp(want['ss'], min=1e-20), 0.0, 1.0)
    return torch.where(valid.cpu() & (ss_y > 0.0), a, torch.zeros_like(a))


def judge_gauss(sample, want, gauss=None):
    """({'gauss_mismatch': share}, info): the sampled Gaussians against
    the reference's (want: reference_gauss). gauss: Gaussians to judge
    in the program's place (the control's: reference_gauss in bfloat16),
    default the program's stored ones. With no chain to judge the share
    is 1: an H2MC window leaves Gaussians on its chains."""
    n = sample['ss'].shape[0]
    if n == 0:
        return dict(gauss_mismatch=1.0), dict(gauss_chains=0,
                                              gauss_eligible=0)
    got = gauss if gauss is not None else sample
    a_ref = want['inv_cov']
    d_a = got['inv_cov'].double() - a_ref
    inv_gap = d_a.flatten(1).norm(dim=1) / a_ref.flatten(1).norm(dim=1)
    d_m = got['mean'].double() - want['mean']
    mean_gap = torch.sqrt(torch.clamp(
        torch.einsum('ci,cij,cj->c', d_m, a_ref, d_m), min=0.0))
    ld_gap = (got['log_det'].double() - want['log_det']).abs()
    gaps = torch.stack([inv_gap, mean_gap, ld_gap])
    bad = ((inv_gap > INV_COV_RTOL) | (mean_gap > MEAN_TOL)
           | (ld_gap > LOG_DET_TOL) | ~torch.isfinite(gaps).all(0))
    info = dict(gauss_chains=n, gauss_eligible=sample['eligible'],
                gauss_fallback=float(want['fallback'].double().mean()),
                gauss_ref_nonfinite=int(want['nonfinite'].sum()),
                widest_inv_cov_gap=_widest(inv_gap),
                widest_mean_gap=_widest(mean_gap),
                widest_log_det_gap=_widest(ld_gap))
    return dict(gauss_mismatch=float(bad.double().mean())), info


def judge_mh(mh, a_ref, a=None):
    """({'mh_mismatch': share}, info): the program's acceptance
    probabilities of take_mh's step against the reference's (a_ref:
    reference_mh). a: probabilities to judge in the program's place (the
    control's: reference_mh in bfloat16). With no chain to judge the
    share is 1."""
    got = (mh['a'] if a is None else a).double()
    if got.shape[0] == 0:
        return dict(mh_mismatch=1.0), dict(mh_chains=0)
    gap = (got - a_ref).abs()
    bad = (gap > MH_TOL) | ~torch.isfinite(gap)
    info = dict(mh_chains=int(gap.shape[0]),
                mh_accept_ref=float(a_ref.mean()),
                mh_valid=float(mh['ok'].double().mean()),
                widest_mh_gap=_widest(gap))
    return dict(mh_mismatch=float(bad.double().mean())), info


def _widest(x):
    return float(torch.nan_to_num(x, nan=np.inf).max())
