"""Each cell runs through the harness at the CPU-sized scene (--small,
which a benchmark run never passes), with the metrics BENCHMARK.json declares
for it, and its sampled chains agree with the reference; a directory
holding only the benchmark runs nothing.

Here only the numbers that do not hang on the window's length are held
to the limits (path_mismatch, grad_mismatch, iterations_not_finite): a
1 s window at the small size runs few iterations. test_bench_faults holds
the whole verdict, with each cell's small_limits, on a sound run and on
planted faults."""

import os
import shutil

import pytest

from _util import CELLS, ROOT, last_json, run_cli
from lmcbench import manifest


@pytest.mark.parametrize('name,trace', [(c, 0) for c in CELLS]
                         + [('torus_box.mala', 1)])
def test_cell_runs_small(name, trace):
    rc, out, err = run_cli(['--workload', name, '--seed', '3000000123',
                            '--seconds', '1', '--trace', str(trace),
                            '--small'])
    assert rc == 0, err[-3000:]
    res = last_json(out)
    cell = manifest.load_cell(name)
    limits = cell.traffic['limits']
    for k in ('path_mismatch', 'grad_mismatch', 'iterations_not_finite'):
        if k in res['check']:
            assert res['check'][k]['value'] <= limits.get(k, 0.0), res
    assert isinstance(res['correct'], bool)
    if trace:
        # the CPU has no device trace, counters of launches or graphs
        assert set(res['metrics']) <= {x['name'] for x in cell.per_layer}
        assert {'bootstrap_s', 'acceptance'} <= set(res['metrics'])
    else:
        assert set(res['metrics']) == {x['name'] for x in cell.end_to_end}
    assert res['attempted'] > 0 and res['failed'] == 0
    assert list(res)[-1] == 'check'
    assert err.strip().splitlines()[-1].startswith('check ')


def test_bare_benchmark_runs_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    (no port) exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    rc, out, _ = run_cli(['--workload', 'torus_box.iso', '--seed', '1',
                          '--seconds', '1', '--trace', '0', '--small'],
                         cwd=str(tmp_path))
    assert rc != 0 and last_json(out) is None


def test_no_card_no_result():
    """Without the --small of the tests, a machine without a card exits
    non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    rc, out, _ = run_cli(['--workload', 'torus_box.iso', '--seed', '1',
                          '--seconds', '1', '--trace', '0'])
    assert rc != 0 and not out.strip()
