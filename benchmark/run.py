"""Run one cell of BENCHMARK.json once on one NVIDIA H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the check
compared, each beside its limit. Exits with 3, and prints no result, when
there is no card (or fewer than the cell asks for), and with 4 when JAX or
the JAX package was loaded. --small runs the cell's CPU-sized scene, on
the CPU where there is no card (the tests).
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of the program and its libraries at a fixed path inside the
# checkout, so that only a checkout's first run builds
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = os.path.join(HERE, '_cache', _sub)
os.environ['USE_FLAX'] = '0'
sys.path[:0] = [HERE, ROOT]

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'langevin_mcmc_tpu')


def _process_start_offset():
    """Seconds between the process's start and T_START (Linux: the
    process's start time in /proc), so that setup_s counts the
    interpreter's start too."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf('SC_CLK_TCK')
        age = uptime - start_ticks / hz
        return max(age - (time.perf_counter() - T_START), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--small', action='store_true',
                   help='the CPU-sized scene (tests)')
    args = p.parse_args(argv)
    t_start = T_START - _process_start_offset()

    import torch
    from lmcbench import cell as cell_mod, manifest
    cell = manifest.load_cell(args.workload)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards >= cell.chips:
        device = torch.device('cuda', 0)
    elif args.small:
        device = torch.device('cpu')
    else:
        print(f'error: {args.workload} needs {cell.chips} CUDA device(s); '
              f'this machine has {n_cards}', file=sys.stderr)
        return 3
    result, rows = cell_mod.run(cell, args.seed, args.seconds,
                                bool(args.trace), device, small=args.small,
                                t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f'error: the run loaded {", ".join(found)}', file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print(f'check {name}: {value!r} (limit {limit!r})', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
