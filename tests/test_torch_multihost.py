"""The port's multi-process render on the CPU, as
tests/test_multihost.py::test_two_process_render runs the JAX package's:

* two real processes of the port's CLI (--coordinator on a free localhost
  port, --num-processes 2, --process-id 0/1, --device cpu; gloo) render
  lcbox at 16x16 with MALA (32 chains, 512 bootstrap samples, maxdepth 3,
  spp 4: 32 iterations in two calls, the cache merged after each, see
  _torch_mh_worker.py): both ranks hold bit-identical films and reduced
  chain films, equal b, and each ran its half of the chains;
* one process with --mesh (and the JAX CLI's --max-derivatives-depth)
  renders through the sharded renderer.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu_torch.__main__ import main as cli_main

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), 'data')


@pytest.fixture(scope='module')
def scene_xml(tmp_path_factory):
    """lcbox at 16x16 with a small <dpt>: 32 chains, 512 bootstrap
    samples, maxdepth 3, directspp 1."""
    d = str(tmp_path_factory.mktemp('lcbox16'))
    for f in ('box_floor.obj', 'box_light.obj'):
        shutil.copy(os.path.join(DATA, f), d)
    with open(os.path.join(DATA, 'lcbox.xml')) as f:
        xml = f.read()
    xml = xml.replace(
        '<integer name="maxdepth"   value="4"/>',
        '<integer name="maxdepth"   value="3"/>\n'
        '        <integer name="numchains" value="32"/>\n'
        '        <integer name="numinitsamples" value="512"/>\n'
        '        <integer name="directspp" value="1"/>')
    xml = re.sub(r'name="(width|height)" value="\d+"', r'name="\1" value="16"',
                 xml)
    path = os.path.join(d, 'scene.xml')
    with open(path, 'w') as f:
        f.write(xml)
    return path


def test_two_process_render(scene_xml, tmp_path):
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), '_torch_mh_worker.py')
    procs = [subprocess.Popen(
        [sys.executable, worker, scene_xml, str(pid), '2',
         f'127.0.0.1:{port}', str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=300)[0].decode(errors='replace')
            for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert 'collectives over gloo (CPU ranks)' in out
    f0 = np.load(tmp_path / 'proc0.npz')
    f1 = np.load(tmp_path / 'proc1.npz')
    assert f0['film'].shape == (16, 16, 3)
    assert np.isfinite(f0['film']).all() and f0['film'].min() >= 0.0
    assert f0['film'].sum() > 0.0 and float(f0['b']) > 0.0
    np.testing.assert_array_equal(f0['chain_film'], f1['chain_film'])
    np.testing.assert_array_equal(f0['film'], f1['film'])
    assert float(f0['b']) == float(f1['b'])
    for pid in range(2):
        with open(tmp_path / f'proc{pid}.json') as f:
            tm = json.load(f)
        assert tm['world'] == 2 and tm['shards'] == 2
        assert tm['steps'] == 32 and tm['merges'] == 2
        assert 0 < tm['accepts'] <= 32 * 16


def test_cli_mesh_one_process(scene_xml, tmp_path):
    res = cli_main([scene_xml, '--device', 'cpu', '--mesh', '--spp', '1',
                    '--chunk', '256', '--max-derivatives-depth', '5',
                    '--output-dir', str(tmp_path)])[0]
    film = res['film']
    assert film.shape == (16, 16, 3)
    assert np.isfinite(film).all() and film.min() >= 0.0 and film.sum() > 0
    assert res['b'] > 0.0
    tm = res['timings']
    assert tm['world'] == 1 and tm['shards'] == 1 and tm['steps'] == 8
    assert os.path.exists(res['exr'])
    np.testing.assert_array_equal(res['chain_film'].shape, film.shape)
