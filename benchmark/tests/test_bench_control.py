"""The control: the plain reference computing in bfloat16 (the nearest
precision below the configurations' float32), put in the program's place
on the same sampled chain records, comes out not correct.

As a test it runs at the CPU-sized scene. On the card it runs at a cell's
own size and prints its readings beside the program's:

    python3 benchmark/tests/test_bench_control.py <cell> <seed>...
"""

import json
import sys

import torch

from _util import THREADS
from lmcbench import cell as cell_mod, check, manifest


def readings(name, seed, device, small, seconds=1.0):
    """The program's compared numbers and the control's, on one seed."""
    cell = manifest.load_cell(name)
    res, _ = cell_mod.run(cell, seed, seconds, False, device, small=small,
                          control=True)
    return res


def test_control_fails_small():
    torch.set_num_threads(int(THREADS))
    res = readings('torus_box.mala', 11, torch.device('cpu'), True)
    limits = manifest.load_cell('torus_box.mala').traffic['limits']
    sound = {k: v['value'] for k, v in res['check'].items()}
    assert sound['path_mismatch'] <= limits['path_mismatch']
    ctl = res['control']
    assert ctl['path_mismatch'] > limits['path_mismatch'], ctl
    assert not check.verdict({k: ctl[k] for k in ('path_mismatch',)},
                             limits)[0]


if __name__ == '__main__':
    name, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    seconds = 10.0
    for seed in seeds:
        r = readings(name, seed, torch.device('cuda', 0), False, seconds)
        print(json.dumps(dict(cell=name, seed=seed, correct=r['correct'],
                              program={k: v['value']
                                       for k, v in r['check'].items()},
                              control=r['control'], info=r['info'])),
              flush=True)
