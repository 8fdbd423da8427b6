"""The kernel phase and the renders of paths B and C of chip_smoke.py for
two trees of this repo, in turns on one GPU:

    python3 compare_trees.py OTHER_ROOT [--no-path-b]

OTHER_ROOT is another checkout of the repo, for example the parent commit
unpacked with `git archive` into _checkout/ (git-ignored). The runs go
other / this / this / other, each in its own process, each with the code
of its own tree: chip_smoke.check_kernels (every kernel variant against
its plain version, timed); the six ray queries through their public
functions, which every tree has, on chip_smoke's kernel rays and on the
large step's first 4,260 of them: CUDA-event ms per query (the torch ray
sort and any torch list or mask stage included) and, from torch.profiler,
the device ms per query of the walk kernels (csrc/) and of all kernels;
then path B (H2MC through the culled sweep, K4) and path C (MC through the
resident chunk walk, K3) through the CLI, each film checked;
--no-path-b leaves path B out (a call of minutes instead of half an
hour). Prints one JSON line per run, and the card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


# names of the walk kernels of every tree (csrc/), for the profiler
KERNEL_NAMES = ('walk_kernel', 'merge_kernel', 'staged_kernel',
                'resident_kernel', 'sweep_kernel')


def query_ms(scene, n):
    """{query: (CUDA-event ms, device ms of the walk kernels, device ms
    of all kernels)} of the six ray queries on the first n of chip_smoke's
    kernel rays."""
    import chip_smoke
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    org, d, mn, mx = (x[:n] for x in chip_smoke.kernel_rays(scene, 65536,
                                                            seed=7))
    z = torch.zeros(n, device=org.device)
    args = (scene, org, d, z, mn, mx)
    queries = {
        'K1 staged closest': lambda: cw.intersect_chunkwalk(*args),
        'K2 staged any': lambda: cw.occluded_chunkwalk(*args),
        'K3 resident closest': lambda: cw.intersect_chunkwalk(
            *args, resident=True),
        'K3 resident any': lambda: cw.occluded_chunkwalk(*args,
                                                         resident=True),
        'K4 sweep closest': lambda: sw.intersect_sweep(*args),
        'K4 sweep any': lambda: sw.occluded_sweep(*args)}
    out = {}
    for name, fn in queries.items():
        ms = chip_smoke.cuda_ms(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in KERNEL_NAMES)) / 5e3
        dev_all = sum(e.self_device_time_total for e in events) / 5e3
        out[name] = (ms, dev, dev_all)
        print(f'query {name}, {n} rays: {ms:.3f} ms; on the device: walk '
              f'kernels {dev:.3f} ms, all kernels {dev_all:.3f} ms',
              flush=True)
    return out


def run(root, path_b):
    """One run with the code of the tree at root (path B only if path_b);
    prints its JSON line."""
    sys.path.insert(0, root)
    import chip_smoke
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.ops import cuda_build
    cuda_build.load_library()
    xml = chip_smoke.write_flagship(os.path.join(chip_smoke.OUT, 'flagship'))
    scene = parse_scene(xml, device='cuda')[0]
    rows = chip_smoke.check_kernels(scene)
    out = {'root': root, 'kernel_ms': {k: r['ms'] for k, r in rows.items()},
           'query_ms': {n: query_ms(scene, n) for n in (65536, 4260)}}
    del scene
    if path_b:
        res_b, launch_b = chip_smoke.render(
            'path B (H2MC)',
            chip_smoke.write_flagship(
                os.path.join(chip_smoke.OUT, 'flagship_h2mc'), kernel='h2mc'),
            {'LMCMC_ISECT_BACKEND': 'pallas'})
        tm = res_b['timings']
        out.update(
            b_loop_ms_per_iteration=1e3 * tm['loop_s'] / tm['steps'],
            b_proposals_per_s=chip_smoke.chain_rate('path B (H2MC)', res_b),
            b_seconds=res_b['seconds'],
            launches_b={k: v for k, v in launch_b.items() if v})
    res_c, launch_c = chip_smoke.render(
        'path C (MC)',
        chip_smoke.write_flagship(os.path.join(chip_smoke.OUT, 'flagship_mc'),
                                  integrator='mc'),
        {'LMC_CW_VMEM_BYTES': str(chip_smoke.RESIDENT_BYTES)})
    out.update(c_seconds=res_c['seconds'],
               launches_c={k: v for k, v in launch_c.items() if v})
    print(json.dumps(out), flush=True)


def main():
    args = [a for a in sys.argv[1:] if a != '--no-path-b']
    path_b = len(args) == len(sys.argv) - 1
    if len(args) == 2 and args[0] == '--run':
        run(os.path.abspath(args[1]), path_b)
        return
    if len(args) != 1:
        raise SystemExit(__doc__)
    other = os.path.abspath(args[0])
    sys.path.insert(0, HERE)
    import chip_smoke
    print(f'card: {chip_smoke.card_line()}', flush=True)
    for root in (other, HERE, HERE, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), '--run',
                        root] + ([] if path_b else ['--no-path-b']),
                       check=True, cwd=root)


if __name__ == '__main__':
    main()
