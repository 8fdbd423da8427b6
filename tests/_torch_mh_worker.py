"""One rank of the port's two-process render (spawned by
test_torch_multihost.py): runs the CLI with the multi-process flags on the
CPU and saves the film, the reduced chain film, b and the timings.

    python _torch_mh_worker.py SCENE.xml PID NPROC HOST:PORT OUT_DIR

The cache merge runs after every call (MERGE_EVERY = 1), so that a short
render merges."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    xml, pid, nproc, coord, out_dir = sys.argv[1:6]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    from langevin_mcmc_tpu_torch.parallel import multihost
    multihost.MERGE_EVERY = 1
    res = cli_main([xml, '--device', 'cpu', '--spp', '4', '--chunk', '256',
                    '--coordinator', coord, '--num-processes', nproc,
                    '--process-id', pid,
                    '--output-dir', os.path.join(out_dir, f'rank{pid}')])[0]
    np.savez(os.path.join(out_dir, f'proc{pid}.npz'), film=res['film'],
             chain_film=res['chain_film'], b=np.float64(res['b']))
    with open(os.path.join(out_dir, f'proc{pid}.json'), 'w') as f:
        json.dump({k: v for k, v in res['timings'].items()
                   if isinstance(v, (int, float))}, f)


if __name__ == '__main__':
    main()
