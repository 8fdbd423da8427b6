"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference imports nothing of the port. Module names are compared by their
whole top-level name, the part before the first dot (the port's name
begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from _util import BENCH, ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'langevin_mcmc_tpu'}
PORT = 'langevin_mcmc_tpu_torch'


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith('.py'))


def test_no_source_imports_jax():
    for path in list(_sources('')):
        for name in _imports(path):
            assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources('lmcref'):
        for name in _imports(path):
            assert name.split('.')[0] != PORT, (path, name)
    code = ('import sys, pkgutil, importlib, lmcref\n'
            'for m in pkgutil.walk_packages(lmcref.__path__, "lmcref."):\n'
            '    importlib.import_module(m.name)\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=BENCH,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert PORT not in tops and not tops & FORBIDDEN


def test_harness_and_port_load_no_jax():
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'import run, lmcbench.cell, lmcbench.check\n'
            'import langevin_mcmc_tpu_torch.integrators.mlt\n'
            'import langevin_mcmc_tpu_torch.integrators.pathtrace\n'
            'import langevin_mcmc_tpu_torch.scene.parse\n'
            'print(run.forbidden_modules())' % (BENCH, ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == '[]'
