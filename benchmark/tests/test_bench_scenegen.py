"""The frozen scene generator writes the same files as the port's
testscenes.py (at the cells' sizes and the tests' small ones)."""

import filecmp
import os

import pytest

from _util import CELLS
from lmcbench import cell as cell_mod, manifest


@pytest.mark.parametrize('small', [True, False])
@pytest.mark.parametrize('name', CELLS)
def test_same_files_as_testscenes(tmp_path, name, small):
    from langevin_mcmc_tpu_torch import testscenes
    cell = manifest.load_cell(name)
    a = cell_mod._write_scene(cell, small, str(tmp_path / 'frozen'))
    c, t = cell.config, cell.traffic
    size = dict(width=c['width'], height=c['height'],
                num_chains=c['num_chains'],
                num_init_samples=c['num_init_samples'])
    if small:
        size = {k: cell_mod.SMALL[k] for k in size}
    b = testscenes.write_scene(
        str(tmp_path / 'port'), small=small, max_depth=c['max_depth'],
        kernel=t['kernel'], integrator='mcmc', scene=c['scene'],
        large_step=t['large_step'], light_coords=t['light_coords'],
        motion=c['motion'], **size)
    da, db = os.path.dirname(a), os.path.dirname(b)
    files = sorted(os.listdir(da))
    assert files == sorted(os.listdir(db)) and 'scene.xml' in files
    _, mismatch, errors = filecmp.cmpfiles(da, db, files, shallow=False)
    assert not mismatch and not errors
