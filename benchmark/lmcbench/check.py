"""The comparison that decides a run's `correct`.

What the window leaves behind is judged once it has closed:

* take() copies, from the program's chain state, a sample of chains drawn
  from the seed (the chains with the longest paths always in it): each
  chain's path record, the contribution, screen position and score the
  program stored for it, the same of its seed state (the bootstrap's
  pick), and, on a MALA cell, the stored gradient of a sample of the
  chains whose gradient belongs to their current record; and the film's
  luminance, the iterations run and the bootstrap's normalisation b.
  Then the program's state can be freed.
* judge() has the plain reference (lmcref, which imports nothing of the
  port) parse the scene files itself and evaluate every sampled record
  again, a perturb replay at a zero offset with every ray query the
  plain brute force, and MALA's gradient through its own frozen replay.

The numbers compared, each against its limit in workloads/<cell>.json:

* path_mismatch: the share of the sampled current and seed chains whose
  stored contribution (RGB) lies more than PATH_RTOL from the
  reference's, relative to the larger of the two, or whose screen
  position lies more than SCREEN_TOL from it. It covers the ray queries
  (closest and any hit), generation and perturb replay (BSDFs, lights,
  textures, the env map, the keyframe lerp) and the accept, which
  commits a proposal's record and values together.
* grad_mismatch (MALA, where the cell's limits hold it): the share of
  the sampled gradient chains whose stored gradient lies more than
  GRAD_RTOL (L2, relative to the larger norm) from the reference's path
  gradient, clipped as MALA clips it. Once a dimension's cache row is
  full its chains take the cache's moments and no gradient: on the box
  every row is full before the window, so no chain there has one.
* unmoved: the share of sampled chains whose record is still their seed
  record: a chain loop that does not advance its chains.
* film_gap: |film luminance / (iterations x chains x b) - 1|. Every
  iteration splats, per valid chain, the current state weighted 1 - a
  and the proposal weighted a, each normalised to luminance b: chains or
  splats left out lower it.
* film_tile_gap: where the film's luminance lands, tile by tile (TILES),
  against where the chains' current splat banks lie: the total variation
  distance between the two distributions over the tiles. An iteration
  splats (1 - a) B(x) + a B(y) for a chain at x proposing y, which is the
  expectation of the bank it commits (B(y) with probability a), so the
  film is a sum of the banks' expectations and its tiles follow the
  chains'. Splats that land in other pixels than their screen positions
  say, or that leave chains out, move it.
* acceptance: accepted proposals over proposals in the window (the chain
  step's device counter), held to a band (lower, upper) of its sound
  readings: an always-accepting step, or one whose MH ratio leaves a term
  out, is another chain.
* b_gap (where the cell's limits hold it): |b / b_ref - 1|, b_ref the
  mean path score of the reference's own B_PATHS bidirectional paths
  drawn from the seed, the bootstrap's normalisation estimated
  independently. On a scene whose path scores have a heavy tail (the
  open scene's sun) the estimate is too noisy to compare.
"""

import contextlib
import dataclasses
import time

import numpy as np
import torch

# a float32 replay against the plain reference's: the walk's Woop test and
# the brute force's Moller-Trumbore give hit distances a few ulps apart,
# and a stored large-step value came from generation, which rounds in
# another order than a replay (the port's tests hold the two at rtol 2e-3
# slot by slot)
PATH_RTOL = 1e-3
# screen positions are in [0, 1): 1e-4 is a tenth of a pixel at 1024
SCREEN_TOL = 1e-4
# both gradients are one autograd pass of the same frozen replay of one
# record; the port's path on a static scene reads a bake of the record
GRAD_RTOL = 1e-3
# chains with the longest paths added to every sample
LONGEST = 16
BLOCK = 1024
# the film_tile_gap grid: tiles across, down
TILES = (8, 6)


def _rng(seed, stream):
    return np.random.default_rng([abs(int(seed)), stream])


def _rec_dict(rec, idx):
    return {f.name: getattr(rec, f.name)[idx].cpu()
            for f in dataclasses.fields(rec)}


def _mala_gaussian(v1, v2, ss, sc, opts):
    """MALA's proposal Gaussian (mean, diagonal sqrt-covariance) from a
    chain's moments, as mala.h states it: the preconditioner
    M = clamp(1 / (1e-3 + sqrt(v2))), cov = 1 / (1 / (ss^2 (M + 1)) +
    1 / shk^2), mean = clamp(v1) cov / 2; a zero-score chain isotropic."""
    M = torch.clamp(1.0 / (1e-3 + torch.sqrt(torch.clamp(v2, min=0.0))),
                    opts.pcd_min, opts.pcd_max)
    shk = opts.mala_std_dev
    cov_t = torch.square(ss)[:, None] * (M + 1.0)
    cov = 1.0 / (1.0 / torch.clamp(cov_t, min=1e-12) + 1.0 / (shk * shk))
    mean = torch.clamp(v1, opts.mtm_min, opts.mtm_max) * cov / 2.0
    zero = (sc <= 1e-10)[:, None]
    return (torch.where(zero, torch.zeros_like(mean), mean),
            torch.where(zero, torch.full_like(cov, shk), torch.sqrt(cov)))


def _gradient_chains(state, cache, opts):
    """[C] bool: the chains whose stored gradient g belongs to their
    current record. A MALA chain on the gradient phase (its PSS dimension
    in the cached range, its cache row not full) stores g when it accepts
    a MALA proposal, and with it the moments and the proposal Gaussian
    built from them; a rejected step re-evaluates the Gaussian at the
    current record but keeps the moments. So g is the current record's
    where the stored Gaussian is the one the stored moments give."""
    dim = 2 * (state.rec.cam_depth + state.rec.lgt_depth - 1)
    in_range = (dim >= opts.pss_min_length) & (dim <= opts.pss_max_length)
    row = torch.clamp(dim, 0, cache.count.shape[0] - 1).long()
    grad_phase = in_range & (cache.count[row] < cache.size)
    mean, cov_l = _mala_gaussian(state.v1, state.v2, state.stepsize,
                                 state.ss_score, opts)
    g = state.gaussian
    same = (torch.isclose(mean, g.mean, rtol=1e-6, atol=1e-12).all(-1)
            & torch.isclose(cov_l, g.cov_l_d, rtol=1e-6, atol=0.0).all(-1))
    return grad_phase & state.gaussian_init & same


def _luminance(rgb):
    rgb = rgb.double()
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] \
        + 0.072169 * rgb[..., 2]


def _tile_sums(screen, lum):
    """[TILES[1] * TILES[0]] luminance summed by the tile of each screen
    position in [0, 1)^2 (clamped as the film clamps pixels)."""
    tx, ty = TILES
    ix = torch.clamp((screen[..., 0].double() * tx).long(), 0, tx - 1)
    iy = torch.clamp((screen[..., 1].double() * ty).long(), 0, ty - 1)
    out = torch.zeros(tx * ty, dtype=torch.float64, device=lum.device)
    return out.index_add_(0, (iy * tx + ix).reshape(-1),
                          lum.reshape(-1).double()).cpu()


def film_tiles(film):
    """The film's luminance summed by tile."""
    h, w = film.shape[-3], film.shape[-2]
    ys = (torch.arange(h, device=film.device, dtype=torch.float64) + 0.5) / h
    xs = (torch.arange(w, device=film.device, dtype=torch.float64) + 0.5) / w
    screen = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]),
                         -1)
    return _tile_sums(screen, _luminance(film))


def bank_tiles(banked):
    """The valid chains' current splat banks' luminance summed by tile."""
    valid = banked.state.valid[:, None]
    lum = torch.where(valid, _luminance(banked.bank_contrib),
                      torch.zeros((), dtype=torch.float64,
                                  device=valid.device))
    return _tile_sums(banked.bank_screen, lum)


def take(seed, banked, init_banked, opts, film, b, iterations, n_sample,
         n_grad, b_paths=0, acceptance=None):
    """The program's outputs the reference judges, copied to the host."""
    st, st0 = banked.state, init_banked.state
    C = st.ls_score.shape[0]
    rng = _rng(seed, 1)
    idx = np.sort(rng.choice(C, min(n_sample, C), replace=False))
    length = (st.rec.cam_depth + st.rec.lgt_depth - 1).cpu().numpy()
    rest = np.setdiff1d(np.argsort(-length, kind='stable'), idx,
                        assume_unique=True)
    order = np.argsort(-length[rest], kind='stable')
    idx = np.sort(np.concatenate([idx, rest[order[:LONGEST]]]))
    it = torch.as_tensor(idx, device=st.ls_score.device)
    out = dict(
        chains=C, idx=idx,
        rec=_rec_dict(st.rec, it), contrib=st.contrib[it].cpu(),
        screen=st.screen_pos[it].cpu(),
        seed_rec=_rec_dict(st0.rec, it), seed_contrib=st0.contrib[it].cpu(),
        seed_screen=st0.screen_pos[it].cpu(),
        film_lum=float(_luminance(film).sum()),
        film_tiles=film_tiles(film), bank_tiles=bank_tiles(banked),
        b=float(b), iterations=int(iterations), grad=None, seed=int(seed),
        b_paths=int(b_paths), acceptance=acceptance)
    if n_grad and opts.mala and not opts.h2mc and banked.cache is not None:
        elig = torch.nonzero(_gradient_chains(st, banked.cache, opts))[:, 0]
        elig = elig.cpu().numpy()
        pick = np.sort(_rng(seed, 2).choice(elig, min(n_grad, len(elig)),
                                            replace=False))
        ig = torch.as_tensor(pick, dtype=torch.long,
                             device=st.ls_score.device)
        out['grad'] = dict(eligible=int(len(elig)), rec=_rec_dict(st.rec, ig),
                           g=st.g[ig].cpu(), ss=st.ss_score[ig].cpu())
    return out


def _ref_record(PathRecord, fields, sl, device, dtype):
    return PathRecord(**{
        k: (v[sl].to(device, dtype) if v.is_floating_point()
            else v[sl].to(device)) for k, v in fields.items()})


class Reference:
    """The plain reference on `device`, computing in `dtype` (float32;
    the control computes in bfloat16): it parses the scene files itself."""

    def __init__(self, xml, device, dtype=torch.float32):
        from lmcref.scene.parse import parse_scene
        self.device, self.dtype = torch.device(device), dtype
        with self._precision():
            self.scene, self.opts, _ = parse_scene(xml, device=self.device,
                                                   dtype=dtype)

    @contextlib.contextmanager
    def _precision(self):
        """Tensors made inside compute in the reference's dtype."""
        old = torch.get_default_dtype()
        torch.set_default_dtype(self.dtype)
        try:
            yield
        finally:
            torch.set_default_dtype(old)

    def paths(self, fields):
        """contrib [n, 3], screen [n, 2] (float32, host) of each record:
        the perturb replay at a zero offset and zero jitters."""
        from lmcref.path.records import PathRecord
        from lmcref.path.replay import replay_path
        n = next(iter(fields.values())).shape[0]
        D = fields['cam_tri'].shape[1]
        cs, ss = [], []
        with self._precision(), torch.no_grad():
            for i in range(0, n, BLOCK):
                sl = slice(i, min(i + BLOCK, n))
                rec = _ref_record(PathRecord, fields, sl, self.device,
                                  self.dtype)
                m = rec.time.shape[0]
                zero = lambda *s: torch.zeros((m,) + s, device=self.device)
                _, res = replay_path(
                    self.scene, self.opts, rec, zero(2 * D),
                    dict(time=zero(), cam_disc=zero(D), lgt_disc=zero(D)),
                    mode='perturb')
                cs.append(res['contrib'].float().cpu())
                ss.append(res['screen_pos'].float().cpu())
        return torch.cat(cs), torch.cat(ss)

    def brightness(self, n, seed, chunk=4096):
        """(mean, standard deviation) over n bidirectional paths of the
        reference's own, drawn from the seed, of the sum of a path's
        technique scores: the bootstrap's normalisation b, estimated
        independently of the program's samples."""
        from lmcref.path import trace
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(_rng(seed, 3).integers(2 ** 62)))
        D = self.opts.max_depth
        sums = []
        with self._precision(), torch.no_grad():
            for i in range(0, n, chunk):
                tape = trace.draw_tape(gen, min(chunk, n - i), D,
                                       self.device)
                _, con, _, _ = trace.generate_path_bidir(
                    self.scene, self.opts, tape,
                    min_depth=max(self.opts.min_depth, 3), max_depth=D)
                sums.append(con.flatten()[0]['ls_score'].double().sum(-1)
                            .cpu())
        x = torch.cat(sums)
        return float(x.mean()), float(x.std())

    def gradients(self, fields, ss_score):
        """MALA's clipped log-luminance gradient [n, 2D] of each record:
        zero where the score is not above 1e-10, scaled down to norm
        mala_gn where it is longer."""
        from lmcref.path.records import PathRecord
        from lmcref.path.replay import path_grad
        n = ss_score.shape[0]
        out = []
        with self._precision():
            for i in range(0, n, BLOCK):
                sl = slice(i, min(i + BLOCK, n))
                rec = _ref_record(PathRecord, fields, sl, self.device,
                                  self.dtype)
                out.append(path_grad(self.scene, self.opts, rec)
                           .float().cpu())
        g = torch.cat(out) if out else torch.zeros((0, 1))
        g = torch.where((ss_score > 1e-10)[:, None], g, torch.zeros_like(g))
        norm = torch.sqrt(torch.sum(torch.square(g), -1, keepdim=True))
        gn = self.opts.mala_gn
        return g * (gn / torch.clamp(norm, min=gn))


def _rel_gap(a, b):
    """Per row: the largest absolute difference over the larger of the
    two rows' largest magnitudes (0 where both are 0)."""
    den = torch.maximum(a.abs().amax(-1), b.abs().amax(-1))
    num = (a - b).abs().amax(-1)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                       torch.zeros_like(num))


def _tv(p, q):
    """Total variation distance of two non-negative histograms, each
    normalised to 1 (1 where either is empty or not finite)."""
    sp, sq = float(p.sum()), float(q.sum())
    if not (sp > 0 and sq > 0 and np.isfinite(sp) and np.isfinite(sq)):
        return 1.0
    return 0.5 * float((p / sp - q / sq).abs().sum())


def _unmoved(cur, seed):
    same = None
    for k, v in cur.items():
        eq = (v == seed[k]).reshape(v.shape[0], -1).all(-1)
        same = eq if same is None else same & eq
    return same


def judge(sample, ref, paths=None, grads=None, b_low=None):
    """The compared numbers and what they were read from. paths: (current
    contrib, screen, seed contrib, screen), grads: the gradient chains'
    gradients and b_low: b, to judge in the program's place (the
    control's), default the program's stored values."""
    cur_c, cur_s = ref.paths(sample['rec'])
    seed_c, seed_s = ref.paths(sample['seed_rec'])
    if paths is None:
        paths = (sample['contrib'], sample['screen'],
                 sample['seed_contrib'], sample['seed_screen'])
    gap = torch.cat([_rel_gap(paths[0].float(), cur_c),
                     _rel_gap(paths[2].float(), seed_c)])
    sgap = torch.cat([(paths[1].float() - cur_s).abs().amax(-1),
                      (paths[3].float() - seed_s).abs().amax(-1)])
    bad = (gap > PATH_RTOL) | (sgap > SCREEN_TOL) | ~torch.isfinite(gap)
    numbers = dict(path_mismatch=float(bad.float().mean()),
                   unmoved=float(_unmoved(sample['rec'], sample['seed_rec'])
                                 .float().mean()),
                   film_gap=abs(sample['film_lum']
                                / (sample['iterations'] * sample['chains']
                                   * sample['b']) - 1.0),
                   film_tile_gap=_tv(sample['film_tiles'],
                                     sample['bank_tiles']))
    if sample.get('acceptance') is not None:
        numbers['acceptance'] = float(sample['acceptance'])
    info = dict(chains_judged=int(gap.shape[0]),
                widest_path_gap=float(torch.nan_to_num(gap, nan=np.inf)
                                      .max()),
                widest_screen_gap=float(sgap.max()))
    if sample.get('b_paths'):
        t0 = time.perf_counter()
        b_ref, b_sd = ref.brightness(sample['b_paths'], sample['seed'])
        b = sample['b'] if b_low is None else b_low
        numbers['b_gap'] = abs(b / b_ref - 1.0)
        info.update(b_ref=b_ref, b_ref_sd=b_sd,
                    b_ref_s=time.perf_counter() - t0)
    gs = sample.get('grad')
    if gs is not None:
        g_ref = ref.gradients(gs['rec'], gs['ss'])
        g = (gs['g'] if grads is None else grads).float()
        den = torch.maximum(g_ref.norm(dim=-1), g.norm(dim=-1))
        ggap = torch.where(den > 0, (g - g_ref).norm(dim=-1)
                           / torch.clamp(den, min=1e-30),
                           torch.zeros_like(den))
        gbad = (ggap > GRAD_RTOL) | ~torch.isfinite(ggap)
        numbers['grad_mismatch'] = float(gbad.float().mean()) \
            if len(ggap) else 0.0
        info.update(grad_chains=int(len(ggap)),
                    grad_eligible=gs['eligible'],
                    widest_grad_gap=float(ggap.max()) if len(ggap) else 0.0)
    return numbers, info


def control(sample, xml, device, ref):
    """The control's numbers: the reference computing in bfloat16, the
    nearest precision below the configuration's float32 (the renderer's
    float32 is elementwise arithmetic, no matmul for TF32 to take), put
    in the program's place on the same sampled records, and estimating b
    from the same paths as the reference does. It runs no chain loop, so
    it reaches path_mismatch, grad_mismatch and b_gap only."""
    low = Reference(xml, device, torch.bfloat16)
    cur = low.paths(sample['rec'])
    seed = low.paths(sample['seed_rec'])
    gs = sample.get('grad')
    grads = None if gs is None else low.gradients(gs['rec'], gs['ss'])
    b_low = low.brightness(sample['b_paths'], sample['seed'])[0] \
        if sample.get('b_paths') else None
    numbers, info = judge(sample, ref, paths=cur + seed, grads=grads,
                          b_low=b_low)
    return dict({k: v for k, v in numbers.items()
                 if k in ('path_mismatch', 'grad_mismatch', 'b_gap')},
                widest_path_gap=info['widest_path_gap'])


def _within(v, lim):
    """v at or below a limit, or inside a band [lower, upper]."""
    if lim is None or not np.isfinite(v):
        return False
    if isinstance(lim, (list, tuple)):
        return lim[0] <= v <= lim[1]
    return v <= lim


def verdict(numbers, limits):
    """(correct, [(name, number, limit)]): every number at or below its
    limit, or inside its band; a number without a limit, or not finite,
    fails."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(_within(v, lim) for _, v, lim in rows)
    return ok, rows
