"""A cell is added as data alone: a copy of the benchmark with one more
traffic file and its manifest entry runs with no code edit. The two cells
PERF.md keeps for later: torus_box.h2mc (H2MC small steps, n_inner 4) and
torus_box.mala_cache (multiplexed, cache-seeded large steps with light
coordinates, the cache pre-filled in set-up)."""

import json
import os
import shutil

import pytest

from _util import ROOT, last_json, run_cli


ADDED = {
    'torus_box.h2mc': dict(kernel='h2mc', large_step='plain',
                           light_coords=False, n_inner=4, setup=[]),
    'torus_box.mala_cache': dict(kernel='mala', large_step='cache',
                                 light_coords=True, n_inner=16,
                                 setup=['prefill_cache']),
}


@pytest.mark.parametrize('name', sorted(ADDED))
def test_cell_added_as_data(tmp_path, name):
    traffic_name = name.split('.', 1)[1]
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        m = json.load(f)
    m['workloads'].append(dict(
        name=name, config='torus_box', traffic=traffic_name, chips=1,
        why='a cell kept for later'))
    for x in m['per_layer']:
        if x['name'] in ('bootstrap_s', 'acceptance'):
            x['workloads'].append(name)
    with open(tmp_path / 'BENCHMARK.json', 'w') as f:
        json.dump(m, f)
    traffic = dict(config='torus_box', traffic=traffic_name,
                   limits=dict(path_mismatch=0.01, unmoved=0.1,
                               film_gap=0.1, grad_mismatch=0.1),
                   **ADDED[name])
    with open(tmp_path / 'benchmark' / 'workloads' / f'{name}.json',
              'w') as f:
        json.dump(traffic, f)
    # the port comes from the repository, the benchmark from the copy
    rc, out, err = run_cli(['--workload', name, '--seed', '5',
                            '--seconds', '1', '--trace', '1', '--small'],
                           cwd=str(tmp_path),
                           env_extra=dict(PYTHONPATH=ROOT))
    assert rc == 0, err[-3000:]
    res = last_json(out)
    assert res['check']['path_mismatch']['value'] == 0.0, res['check']
    assert set(res['metrics']) == {'bootstrap_s', 'acceptance'}
