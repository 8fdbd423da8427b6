"""CLI: render a Mitsuba-style scene XML with the PyTorch port.

    python -m langevin_mcmc_tpu_torch scene.xml [--spp N] [--device cpu]

Dispatches on the <dpt> integrator: "mcmc" (isotropic, MALA or H2MC
small steps with plain, multiplexed or cache-seeded large steps) or "mc"
(bidirectional path tracing); shapes, the camera and the env map may move
between two keyframes. Writes <output>_timeuse_<seconds>s.exr and .png into
--output-dir, and intermediate.exr/.png there every reportintervalspp spp
of a single-process MCMC render. Renders on the card; on a machine without
one, --device cpu must be given.

--trace FILE turns the trace registry on (ops/tracing) before the first
render, writes its host spans to FILE as a Chrome-trace JSON when the
last has ended, and puts each render's stages in its timings
('stages_ms': self and inclusive milliseconds and the intervals of each
span) with the small steps' lane counters ('lanes': knn_need,
h2mc_lanes, h2mc_fallback and hess_nonfinite, each by side).

Multi-process: one process per rank with --coordinator host:port
--num-processes N --process-id i (each rank on cuda:{i % cards}); an MCMC
scene then renders with its chains sharded over the ranks
(parallel/multihost.py), as it does in one process with --mesh. Every rank
writes its image.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    """Run the CLI. Returns a dict per scene: film (numpy [H, W, 3]),
    b (MCMC normalization or None), seconds, timings, paths written and,
    for a sharded MCMC render, chain_film (the reduced chain film)."""
    p = argparse.ArgumentParser(prog='langevin_mcmc_tpu_torch',
                                description='gradient-based MCMC renderer '
                                            '(PyTorch/CUDA)')
    p.add_argument('scenes', nargs='+', help='scene XML files')
    p.add_argument('--seedoffset', type=int, default=0, help='RNG seed')
    p.add_argument('--max-derivatives-depth', type=int, default=8,
                   help='max path depth for derivative kernels (unused: '
                        'autograd handles any depth; kept for CLI parity)')
    p.add_argument('--film-scale', type=float, default=1.0,
                   help='scale film resolution (debugging)')
    p.add_argument('--spp', type=int, default=None, help='override spp')
    p.add_argument('--chunk', type=int, default=8192,
                   help='wavefront size of the generation passes')
    p.add_argument('--output-dir', default='.', help='output directory')
    p.add_argument('--device', default='cuda',
                   help='torch device (default: cuda; the CPU only when '
                        'asked for)')
    p.add_argument('--mesh', action='store_true',
                   help='render MCMC scenes through the sharded renderer '
                        '(parallel/multihost.py) in a single process too')
    p.add_argument('--coordinator', default=None,
                   help='multi-process coordinator address host:port')
    p.add_argument('--num-processes', type=int, default=None,
                   help='multi-process rank count')
    p.add_argument('--process-id', type=int, default=None,
                   help='this process\'s rank (multi-process)')
    p.add_argument('--trace', default=None, metavar='FILE',
                   help='trace the renders: host spans to FILE (Chrome '
                        'trace JSON), stage times in the timings')
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('error: no CUDA device; pass --device cpu to render on the '
              'CPU', file=sys.stderr)
        sys.exit(2)
    os.makedirs(args.output_dir, exist_ok=True)
    from .parallel.multihost import init_distributed, render_mlt_multihost
    rank_device = init_distributed(args.coordinator, args.num_processes,
                                   args.process_id, device)
    distributed = rank_device is not None
    device = rank_device or device
    from .scene.parse import parse_scene, parse_scene_host
    from .integrators.pathtrace import render_mc
    from .integrators.mlt import render_mlt
    from .ops import tracing
    from .utils import image_io
    if args.trace:
        tracing.enable(device)

    results = []
    for scene_file in args.scenes:
        if not os.path.exists(scene_file):
            print(f'error: scene file not found: {scene_file}',
                  file=sys.stderr)
            sys.exit(1)
        print(f'parsing {scene_file}')
        film_wh = None
        if args.film_scale != 1.0:
            cam = parse_scene_host(scene_file)[0]['camera']
            film_wh = (int(cam['width'] * args.film_scale),
                       int(cam['height'] * args.film_scale))
        scene, opts, output_name = parse_scene(scene_file, film_wh=film_wh,
                                               device=device)
        opts = opts.replace(seed_offset=args.seedoffset)
        if args.spp is not None:
            opts = opts.replace(spp=args.spp)
        gen = torch.Generator(device=device)
        gen.manual_seed(opts.seed_offset)

        timings, parts = {}, {}
        traced0 = tracing.snapshot() if args.trace else None
        t0 = time.time()
        with torch.no_grad():
            if opts.integrator == 'mc':
                film = render_mc(scene, opts, gen, chunk=args.chunk)
                b = None
            elif distributed or args.mesh:
                film, b = render_mlt_multihost(
                    scene, opts, opts.seed_offset, chunk=args.chunk,
                    progress=True, timings=timings, parts=parts)
            else:
                film, b = render_mlt(
                    scene, opts, gen, chunk=args.chunk, progress=True,
                    timings=timings, intermediate_path=os.path.join(
                        args.output_dir, 'intermediate'))
        film = film.cpu().numpy()
        elapsed = time.time() - t0
        if args.trace:
            traced = tracing.delta(traced0, tracing.snapshot())
            timings['stages_ms'] = tracing.stages_ms(traced)
            timings['lanes'] = traced['lanes']
        if b is not None:
            print(f'Average brightness:{b}')
        print(f'Elapsed time:{elapsed}')
        base = os.path.join(args.output_dir, output_name)
        hdr = f'{base}_timeuse_{elapsed:.6f}s.exr'
        ldr = f'{base}_timeuse_{elapsed:.6f}s.png'
        image_io.write_image(hdr, film)
        image_io.write_image(ldr, film)
        print(f'wrote {hdr}')
        print('Done!')
        results.append(dict(film=film, b=b, seconds=elapsed, timings=timings,
                            opts=opts, exr=hdr, png=ldr,
                            **{k: v.cpu().numpy() for k, v in parts.items()}))
    if args.trace:
        tracing.write_chrome_trace(args.trace)
        print(f'wrote {args.trace}')
    return results


if __name__ == '__main__':
    main()
