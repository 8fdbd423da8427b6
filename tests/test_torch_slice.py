"""The port's slice end to end on the CPU, and its independence from JAX.

* ``python -m langevin_mcmc_tpu_torch`` (main([...])) on lcbox at 64x48,
  with the <dpt> block cut to a few thousand bootstrap samples so it runs
  in seconds: the EXR and PNG are written, the film is finite and
  non-negative and not all zero;
* every module of the package imports with ``sys.modules['jax'] = None``
  in a fresh interpreter, and none of them pulls in langevin_mcmc_tpu.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from langevin_mcmc_tpu_torch.__main__ import main
from langevin_mcmc_tpu_torch.utils import image_io
from torch_parity import LCBOX

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_renders_lcbox(tmp_path):
    data = os.path.dirname(LCBOX)
    for f in ('box_floor.obj', 'box_light.obj'):
        shutil.copy(os.path.join(data, f), tmp_path)
    with open(LCBOX) as f:
        xml = f.read()
    cut = ('<integer name="numinitsamples" value="4096"/>'
           '<integer name="directspp" value="4"/>'
           '<integer name="numchains" value="256"/></dpt>')
    xml = xml.replace('</dpt>', cut, 1)
    scene_xml = os.path.join(tmp_path, 'lcbox_cut.xml')
    with open(scene_xml, 'w') as f:
        f.write(xml)
    out = os.path.join(tmp_path, 'out')
    res = main([scene_xml, '--spp', '2', '--output-dir', out, '--device',
                'cpu', '--chunk', '4096'])
    assert len(res) == 1
    r = res[0]
    assert os.path.exists(r['exr']) and os.path.exists(r['png'])
    img = image_io.read_image(r['exr'])
    assert img.shape == (48, 64, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert img.mean() > 0.0
    np.testing.assert_allclose(img, r['film'], rtol=1e-6)
    # 2 spp over 256 chains is 24 iterations, rounded up to whole calls of
    # 16 as the JAX package's render loop rounds them
    assert r['b'] > 0.0 and r['timings']['steps'] == 32


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import langevin_mcmc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'langevin_mcmc_tpu'\n"
        "       or m.startswith('langevin_mcmc_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')
