"""The check fails a run whose timed path is broken underneath: the
harness runs the cell at the CPU-sized scene (skipping its look for a
card) with a fault planted in the port, and `correct` comes out false,
once for each fault a one-chip renderer cell can have: a state left
unchanged, half the chains left out, splats left out or landing in the
wrong rows, every proposal accepted, and an answer altered where it is
produced. (No cell crosses chips, so there is no exchange between chips
to leave out.)"""

import dataclasses

import pytest
import torch

from _util import THREADS
from lmcbench import cell as cell_mod, manifest


def _step_fault(monkeypatch, wrap):
    from langevin_mcmc_tpu_torch.integrators import mlt
    orig = mlt.make_mlt_step

    def make(*a, **k):
        step = orig(*a, **k)
        broken = wrap(step)
        broken.counts = step.counts
        return broken
    monkeypatch.setattr(mlt, 'make_mlt_step', make)


def unchanged(monkeypatch):
    """The step splats but returns its state unchanged."""
    def wrap(step):
        def broken(gen, banked, film, init_banked):
            step(gen, banked, film, init_banked)
            return banked
        return broken
    _step_fault(monkeypatch, wrap)


def half_left_out(monkeypatch):
    """The second half of the chains keeps its state every iteration."""
    from langevin_mcmc_tpu_torch.utils.tree import tree_where

    def wrap(step):
        def broken(gen, banked, film, init_banked):
            new = step(gen, banked, film, init_banked)
            C = banked.state.ls_score.shape[0]
            keep = torch.arange(C) >= C // 2
            return dataclasses.replace(
                new, state=tree_where(keep, banked.state, new.state),
                bank_screen=torch.where(keep[:, None, None],
                                        banked.bank_screen, new.bank_screen),
                bank_contrib=torch.where(keep[:, None, None],
                                         banked.bank_contrib,
                                         new.bank_contrib))
        return broken
    _step_fault(monkeypatch, wrap)


def splats_halved(monkeypatch):
    """Half of every splat's weight is left out of the film."""
    from langevin_mcmc_tpu_torch.integrators import mlt
    orig = mlt.splat

    def broken(film, screen, contrib, **k):
        return orig(film, screen, contrib * 0.5, **k)
    monkeypatch.setattr(mlt, 'splat', broken)


def always_accept(monkeypatch):
    """Every proposal with a non-zero contribution is accepted: the large
    and small steps' acceptance probabilities come out 1 wherever they are
    above 0."""
    from langevin_mcmc_tpu_torch.mcmc import chain
    for name in ('large_step', 'large_step_multiplexed', 'large_step_cache',
                 'small_step_iso', 'small_step_mala', 'small_step_h2mc'):
        orig = getattr(chain, name)

        def broken(*a, _orig=orig, **k):
            prop, acc = _orig(*a, **k)
            return prop, (acc > 0.0).to(acc.dtype)
        monkeypatch.setattr(chain, name, broken)


def density_dropped(monkeypatch):
    """The MH ratio of MALA's (and H2MC's) small step leaves out the
    proposal densities' ratio q(x | y) / q(y | x)."""
    from langevin_mcmc_tpu_torch.mcmc import gaussian
    monkeypatch.setattr(gaussian, 'gaussian_log_pdf',
                        lambda offset, g: torch.zeros(offset.shape[:-1],
                                                      device=offset.device))


def splats_flipped(monkeypatch):
    """Every splat lands in the film's rows mirrored top to bottom."""
    from langevin_mcmc_tpu_torch.integrators import mlt
    orig = mlt.splat

    def broken(film, screen, contrib, **k):
        return orig(film, torch.stack([screen[..., 0], 1.0 - screen[..., 1]],
                                      -1), contrib, **k)
    monkeypatch.setattr(mlt, 'splat', broken)


def answer_altered(monkeypatch):
    """The perturb replay's contribution comes out 1% high."""
    from langevin_mcmc_tpu_torch.path import replay
    orig = replay.replay_path

    def broken(*a, **k):
        out = orig(*a, **k)
        res = dict(out[1], contrib=out[1]['contrib'] * 1.01)
        return (out[0], res) + tuple(out[2:])
    monkeypatch.setattr(replay, 'replay_path', broken)


@pytest.mark.parametrize('fault,name', [
    (unchanged, 'torus_box.iso'), (half_left_out, 'torus_box.iso'),
    (splats_halved, 'torus_box.iso'), (splats_flipped, 'torus_box.iso'),
    (always_accept, 'torus_box.iso'),
    (answer_altered, 'torus_box.iso'), (answer_altered, 'torus_box.mala')])
def test_fault_fails_the_check(monkeypatch, fault, name):
    torch.set_num_threads(int(THREADS))
    fault(monkeypatch)
    res, rows = cell_mod.run(manifest.load_cell(name), 77, 0.5, False,
                             torch.device('cpu'), small=True)
    assert res['correct'] is False, rows


def test_sound_run_passes():
    torch.set_num_threads(int(THREADS))
    res, rows = cell_mod.run(manifest.load_cell('torus_box.iso'), 77, 0.5,
                             False, torch.device('cpu'), small=True)
    assert res['correct'] is True, rows


FAULTS = {f.__name__: f for f in (unchanged, half_left_out, splats_halved,
                                  always_accept, density_dropped,
                                  splats_flipped, answer_altered)}


if __name__ == '__main__':
    # the readings of a fault planted in the port, at a cell's own size on
    # the card (or 'sound' for none):
    #   python3 benchmark/tests/test_bench_faults.py <cell> <fault> <seed>...
    import json
    import sys
    name, fault = sys.argv[1], sys.argv[2]
    for seed in [int(s) for s in sys.argv[3:]]:
        mp = pytest.MonkeyPatch()
        if fault != 'sound':
            FAULTS[fault](mp)
        try:
            res, _ = cell_mod.run(manifest.load_cell(name), seed, 1.0, False,
                                  torch.device('cuda', 0))
        finally:
            mp.undo()
        print(json.dumps(dict(cell=name, fault=fault, seed=seed,
                              correct=res['correct'],
                              check={k: v['value']
                                     for k, v in res['check'].items()},
                              info=res['info'])), flush=True)
