"""BENCHMARK.json keeps to the benchmark format's names and shapes, and every
cell's files resolve by name."""

import os
import re

import pytest

from _util import BENCH, CELLS, ROOT
from lmcbench import manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
LINE = re.compile(r'^[^\n\t]{1,200}$')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')


@pytest.fixture(scope='module')
def m():
    return manifest.load_manifest()


def test_top_level_keys(m):
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= m['run_seconds'] <= 51
    assert 1 <= len(m['paths']) <= 16
    for p in m['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch')
    assert 1 <= len(m['command']) <= 32
    for word in m['command']:
        assert LINE.match(word) and not word.startswith('/')
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024


def test_names_and_units(m):
    names = []
    for c in m['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert LINE.match(c['source']) and LINE.match(c['why'])
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith(m['paths'][0] + '/')
        names.append(c['name'])
    for w in m['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] == 1 and LINE.match(w['why'])
        names.append(w['name'])
    for x in m['end_to_end'] + m['per_layer']:
        assert NAME.match(x['name']) and UNIT.match(x['unit'])
        assert x['better'] in ('lower', 'higher')
        assert x['source'] in SOURCES
        names.append(x['name'])
    for x in m['end_to_end']:
        assert set(x) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert x['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= x['bound'] <= 0.25
    e2e = {x['name'] for x in m['end_to_end']}
    for x in m['per_layer']:
        assert set(x) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert LINE.match(x['layer']) and x['moves'] in e2e
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    pairs = [(w['config'], w['traffic']) for w in m['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_resolve(m, name):
    cell = manifest.load_cell(name, m)
    e2e = {x['name'] for x in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for x in cell.per_layer:
        assert callable(manifest.load_reader(x['name']))
    for step in cell.traffic.get('setup', []):
        assert callable(manifest.load_setup_step(step))
    assert {'path_mismatch', 'unmoved', 'film_gap', 'film_tile_gap',
            'acceptance'} <= set(cell.traffic['limits'])
    lo, hi = cell.traffic['limits']['acceptance']
    assert 0.0 <= lo < hi <= 1.0


def test_every_config_and_cell_used(m):
    used = {w['config'] for w in m['workloads']}
    assert used == {c['name'] for c in m['configs']}
    cells = {w['name'] for w in m['workloads']}
    for x in m['end_to_end'] + m['per_layer']:
        assert set(x.get('workloads', cells)) <= cells
    for c in m['configs']:
        assert os.path.isfile(os.path.join(ROOT, c['file']))
    assert sorted(os.listdir(os.path.join(BENCH, 'workloads'))) == \
        sorted(f'{n}.json' for n in cells)
