"""The port's MALA MCMC render against its own plain MC on the small
generated open scene (env map with a sun, point light, area light,
textures, rough dielectric), as test_torch_mcmc does on lcbox; and the
CLI on the open scene.

MC and MCMC come from independent estimators (MC: bidirectional path
tracing; MCMC: the direct pass plus MALA chains over depths >= 3), so
their agreement checks the new branches' contributions and pdfs end to
end. maxDepth 3, 32x24 film, 32 MC samples a pixel, 100 iterations of
256 chains; the means agree within 10% and the row profiles correlate
above 0.9, the bounds of test_torch_mcmc."""

import os
import shutil

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.__main__ import main
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.integrators.pathtrace import render_mc
from langevin_mcmc_tpu_torch.integrators.mlt import render_mlt
from langevin_mcmc_tpu_torch.utils import image_io
from torch_parity import to_np

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def open_xml(tmp_path_factory):
    return testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                  small=True, width=32, height=24,
                                  max_depth=3, num_init_samples=4096,
                                  scene='open')


def test_mcmc_matches_mc_mean_open_scene(open_xml):
    scene, opts, _ = parse_scene(open_xml, device='cpu')
    opts = opts.replace(direct_spp=16, num_chains=256,
                        large_step_probability=0.3)
    with torch.no_grad():
        mc = to_np(render_mc(scene, opts.replace(spp=32),
                             torch.Generator().manual_seed(0), chunk=4096))
        film, b = render_mlt(scene, opts, torch.Generator().manual_seed(1),
                             num_steps=100, chunk=4096)
    img = to_np(film)
    assert np.isfinite(img).all() and img.min() >= 0.0
    m_mc, m_mlt = mc.mean(), img.mean()
    assert abs(m_mlt - m_mc) / m_mc < 0.10, f'MC {m_mc} vs MCMC {m_mlt}'
    corr = np.corrcoef(mc.mean((1, 2)), img.mean((1, 2)))[0, 1]
    assert corr > 0.9, f'row correlation {corr}'


def test_cli_renders_open_scene(open_xml, tmp_path):
    """python -m langevin_mcmc_tpu_torch <open scene> --device cpu --spp 1:
    EXR and PNG written; the film is finite, non-negative, not zero, and
    the sky lights its top rows."""
    d = tmp_path / 'scene'
    shutil.copytree(os.path.dirname(open_xml), d)
    xml = d / 'scene.xml'
    xml.write_text(xml.read_text().replace(
        '<integer name="numchains" value="65536"/>',
        '<integer name="numchains" value="256"/>'))
    out = str(tmp_path / 'out')
    res = main([str(xml), '--spp', '1', '--output-dir', out, '--device',
                'cpu', '--chunk', '4096'])
    r = res[0]
    assert os.path.exists(r['exr']) and os.path.exists(r['png'])
    img = image_io.read_image(r['exr'])
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert img.mean() > 0.0 and img[:3].mean() > 0.0
