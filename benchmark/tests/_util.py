"""Paths and helpers of the benchmark's own tests (run on the CPU:
python -m pytest benchmark/tests -q)."""

import json
import os
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELLS = ('torus_box.mala', 'torus_box.iso')
THREADS = '4'


def run_cli(args, cwd=ROOT, env_extra=None, timeout=900):
    """run.py in a subprocess: (returncode, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS=THREADS)
    env.pop('PYTHONPATH', None)
    env.update(env_extra or {})
    p = subprocess.run([sys.executable, os.path.join(cwd, 'benchmark',
                                                     'run.py')] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else None
