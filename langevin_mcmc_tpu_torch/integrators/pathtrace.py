"""Plain Monte Carlo integrators: path tracing and the direct-lighting pass
(port of integrators/pathtrace.py). Whole pixel wavefronts are traced per
chunk and splatted into the film."""

import torch

from ..ops import tracing
from ..ops.film import splat
from ..path import trace


def render_mc(scene, opts, generator, spp=None, bidirectional=None,
              min_depth=None, max_depth=None, chunk=16384):
    """Path-trace the image. Returns film [H, W, 3] averaged over spp."""
    spp = opts.spp if spp is None else spp
    bidirectional = opts.bidirectional if bidirectional is None \
        else bidirectional
    min_depth = opts.min_depth if min_depth is None else min_depth
    max_depth = opts.max_depth if max_depth is None else max_depth
    dev = scene.device
    npix = scene.width * scene.height
    gen = trace.generate_path_bidir if bidirectional \
        else trace.generate_path_uni
    film = torch.zeros((scene.height, scene.width, 3), device=dev)
    for _ in range(spp):
        for start in range(0, npix, chunk):
            ids = torch.arange(start, min(start + chunk, npix), device=dev)
            pix = torch.stack([ids % scene.width, ids // scene.width], -1)
            tape = trace.draw_tape(generator, ids.shape[0], opts.max_depth,
                                   dev)
            con = gen(scene, opts, tape, pixel=pix, min_depth=min_depth,
                      max_depth=max_depth)[1]
            flat, _, _ = con.flatten()
            keep = flat['ls_score'] > 1e-10
            contrib = torch.where(keep[..., None], flat['contrib'],
                                  torch.zeros_like(flat['contrib'])) / spp
            splat(film, flat['screen_pos'].reshape(-1, 2),
                  contrib.reshape(-1, 3))
    return film


def render_direct(scene, opts, generator, chunk=16384):
    """Direct-lighting pass: unidirectional, depths <= 2, direct_spp
    samples per pixel. Returns the per-spp-averaged film. Traced as the
    span pathtrace.direct."""
    if opts.min_depth > 2 or opts.max_depth < 1:
        return torch.zeros((scene.height, scene.width, 3), device=scene.device)
    with tracing.span('pathtrace.direct'):
        return render_mc(scene, opts, generator, spp=opts.direct_spp,
                         bidirectional=False,
                         min_depth=min(opts.min_depth, 2),
                         max_depth=min(opts.max_depth, 2), chunk=chunk)
