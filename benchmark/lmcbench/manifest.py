"""BENCHMARK.json and the files it names, found by name: a cell's entry
and its traffic file (workloads/<cell>.json), its configuration file, and
the metrics it reports (end to end with --trace 0, per layer with --trace
1), each per-layer metric with its reader (metrics/<name>.py)."""

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, 'BENCHMARK.json')


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # workloads/<cell>.json
    end_to_end: list    # the manifest's metric entries this cell reports
    per_layer: list


def load_manifest(path=MANIFEST):
    with open(path) as f:
        return json.load(f)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric, cell_name):
    return 'workloads' not in metric or cell_name in metric['workloads']


def load_cell(name, manifest=None, bench_dir=BENCH_DIR):
    """The cell `name` of the manifest, with its files read. Raises
    KeyError for a cell the manifest does not have and ValueError where a
    file disagrees with the manifest's entry."""
    m = load_manifest() if manifest is None else manifest
    entry = {w['name']: w for w in m['workloads']}[name]
    conf = {c['name']: c for c in m['configs']}[entry['config']]
    config = _read_json(os.path.join(os.path.dirname(bench_dir),
                                     conf['file']))
    traffic = _read_json(os.path.join(bench_dir, 'workloads',
                                      f'{name}.json'))
    for key, want in (('config', entry['config']),
                      ('traffic', entry['traffic'])):
        if traffic.get(key) != want:
            raise ValueError(f'workloads/{name}.json: {key} '
                             f'{traffic.get(key)!r}, the manifest says '
                             f'{want!r}')
    if config.get('name') != entry['config']:
        raise ValueError(f'{conf["file"]}: name {config.get("name")!r}')
    return Cell(name=name, chips=int(entry['chips']), config=config,
                traffic=traffic,
                end_to_end=[x for x in m['end_to_end'] if _reports(x, name)],
                per_layer=[x for x in m['per_layer'] if _reports(x, name)])


def _module(sub, name, bench_dir):
    path = os.path.join(bench_dir, sub, f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'lmcbench_{sub}_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric_name, bench_dir=BENCH_DIR):
    """metrics/<name>.py's read(ctx) -> a number, or None where the run
    has nothing for it to read."""
    return _module('metrics', metric_name, bench_dir).read


def load_setup_step(step_name, bench_dir=BENCH_DIR):
    """setup_steps/<name>.py's run(ctx): a set-up step a traffic file
    names (such as a cache pre-fill), run after the bootstrap and before
    the render's first multi-step call."""
    return _module('setup_steps', step_name, bench_dir).run
