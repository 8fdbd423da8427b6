"""CLI: render a Mitsuba-style scene XML with the PyTorch port.

    python -m langevin_mcmc_tpu_torch scene.xml [--spp N] [--device cpu]

Dispatches on the <dpt> integrator: "mcmc" (MALA or H2MC small steps with
plain large steps) or "mc" (bidirectional path tracing). Writes
<output>_timeuse_<seconds>s.exr and .png into --output-dir. Renders on the
card; on a machine without one, --device cpu must be given.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    """Run the CLI. Returns a dict per scene: film (numpy [H, W, 3]),
    b (MCMC normalization or None), seconds, timings, paths written."""
    p = argparse.ArgumentParser(prog='langevin_mcmc_tpu_torch',
                                description='gradient-based MCMC renderer '
                                            '(PyTorch/CUDA)')
    p.add_argument('scenes', nargs='+', help='scene XML files')
    p.add_argument('--seedoffset', type=int, default=0, help='RNG seed')
    p.add_argument('--film-scale', type=float, default=1.0,
                   help='scale film resolution (debugging)')
    p.add_argument('--spp', type=int, default=None, help='override spp')
    p.add_argument('--chunk', type=int, default=8192,
                   help='wavefront size of the generation passes')
    p.add_argument('--output-dir', default='.', help='output directory')
    p.add_argument('--device', default='cuda',
                   help='torch device (default: cuda; the CPU only when '
                        'asked for)')
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('error: no CUDA device; pass --device cpu to render on the '
              'CPU', file=sys.stderr)
        sys.exit(2)
    os.makedirs(args.output_dir, exist_ok=True)
    from .scene.parse import parse_scene, parse_scene_host
    from .integrators.pathtrace import render_mc
    from .integrators.mlt import render_mlt
    from .utils import image_io

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

        timings = {}
        t0 = time.time()
        with torch.no_grad():
            if opts.integrator == 'mc':
                film = render_mc(scene, opts, gen, chunk=args.chunk)
                b = None
            else:
                film, b = render_mlt(scene, opts, gen, chunk=args.chunk,
                                     progress=True, timings=timings)
        film = film.cpu().numpy()
        elapsed = time.time() - t0
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
                            opts=opts, exr=hdr, png=ldr))
    return results


if __name__ == '__main__':
    main()
