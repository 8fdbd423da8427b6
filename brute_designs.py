"""Design points of the brute-force kernel (csrc/brute.cu) beside the
kernel before its redesign, on one GPU:

    python3 brute_designs.py [--parent DIR]

On the flagship moving open scene (full width, chip_smoke.write_flagship
with motion) with chip_smoke.py's motion rays (motion_rays) at 65,536 rays
and the large step's 4,260, and on the flagship static box with
LMCMC_ISECT_BACKEND=brute's query on chip_smoke.py's kernel rays, closest
and any hit, in one process:
  * pr11: the first design (every live ray against every triangle in id
    order), from DIR/langevin_mcmc_tpu_torch/csrc/{brute.cu,tri.cuh}
    (default _checkout/parent, e.g. `git archive 73db527 | tar -x -C
    _checkout/parent`) or else `git show 73db527:...`, built into a copy
    under smoke_out/brute_designs/ and called through its own entry point;
  * committed: intersect.brute_force as it is (the rays as they come);
  * sorted: the query with the rays sorted first as the chunk walk sorts
    them (chunkwalk._sort_rays: dead last, origin Morton cell, direction
    octant), gathered, passed to the committed kernel and the outputs
    scattered back;
  * q2e-3, q8e-3: the committed kernel on tables built with
    brute_tiles.Q_MIN, the least conditioning of a culled pair, set to
    2e-3 and 8e-3 (4e-3 committed): less screening and more padding, or
    the reverse;
  * rcp_rn, rcp_approx: the test's IEEE division 1 / div replaced by
    __frcp_rn (the correctly rounded reciprocal) or by __fdividef (the
    approximate one), patched copies of csrc/tri.cuh (timing only: they
    answer what the division costs; rcp_rn's equality is printed).
Every point but the division ones is first checked equal to the plain
version (_bruteforce_live) bit for bit; then each is timed with CUDA events
(chip_smoke.cuda_ms_launches: 20 calls back to back, median of 5), twice,
the points in one order and then in the reverse order, and the mean of
the two medians is reported. Prints ptxas's report of each build, per
query the committed tables' tiles on a block's list (mean, p99) and the
pairs the rays test against live rays x triangles (brute_tiles.
query_stats), a line of times per query and one JSON line, also written
to chiprun_out/brute_designs.json.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'smoke_out', 'brute_designs')
PARENT = '73db527'
_P, _I = ctypes.c_void_p, ctypes.c_int
# the first design's entry point: triangles and their count, the rays,
# (rays, splits, motion, any_hit), the ranges' partials, the closest hit's
# outputs, occluded, the stream
_PARENT_SIG = [_P, _I] + [_P] * 5 + [_I] * 4 + [_P] * 9 + [_P]
_DIV = '  const float inv_div = 1.0f / clamped;\n'
DIVISION = {'rcp_rn': '  const float inv_div = __frcp_rn(clamped);\n',
            'rcp_approx':
                '  const float inv_div = __fdividef(1.0f, clamped);\n'}


def parent_csrc(root):
    """A directory holding the first design's brute.cu and tri.cuh."""
    src = os.path.join(root, 'langevin_mcmc_tpu_torch', 'csrc')
    if os.path.exists(os.path.join(src, 'brute.cu')):
        return src
    out = os.path.join(OUT, 'pr11_src')
    os.makedirs(out, exist_ok=True)
    for name in ('brute.cu', 'tri.cuh'):
        text = subprocess.run(
            ['git', 'show', f'{PARENT}:langevin_mcmc_tpu_torch/csrc/{name}'],
            cwd=HERE, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(out, name), 'w') as f:
            f.write(text)
    return out


def build(name, patches=(), csrc=None):
    from langevin_mcmc_tpu_torch.ops import cuda_build
    kw = {} if csrc is None else dict(csrc=csrc)
    lib, reports = cuda_build.build_copy(os.path.join(OUT, name),
                                         list(patches), sources=['brute.cu'],
                                         **kw)
    print(f'{name} brute.cu ptxas:\n{reports["brute.cu"]}', flush=True)
    return lib


@contextlib.contextmanager
def library(lib):
    """intersect's launches go to lib (a patched copy) inside."""
    from langevin_mcmc_tpu_torch.ops import cuda_build
    saved = cuda_build._lib
    cuda_build._lib = lib
    try:
        yield
    finally:
        cuda_build._lib = saved


def with_q_min(scene, q_min):
    """scene with tables built at brute_tiles.Q_MIN = q_min."""
    from langevin_mcmc_tpu_torch.ops import brute_tiles
    saved = brute_tiles.Q_MIN
    brute_tiles.Q_MIN = q_min
    try:
        return brute_tiles.attach(scene)
    finally:
        brute_tiles.Q_MIN = saved


def _ptr(x):
    return None if x is None else x.data_ptr()


def parent_call(fn, scene, rays, any_hit):
    """The first design's launch (its wrapper as of commit 73db527)."""
    from langevin_mcmc_tpu_torch.ops import cuda_build, intersect
    R, T, dev = rays[0].shape[0], scene.num_tris, rays[0].device
    tiles = -(-T // intersect.BRUTE_RAYS)
    blocks = -(-R // intersect.BRUTE_RAYS)
    s = max(1, min(tiles, -(-intersect.BRUTE_CTAS // blocks)))
    S = -(-tiles // -(-tiles // s))
    part = [torch.empty((S, R), dtype=dt, device=dev) for dt in
            (torch.float32, torch.int32, torch.float32, torch.float32)]
    if any_hit:
        out = occ = torch.empty(R, dtype=torch.bool, device=dev)
        res = (None,) * 4
    else:
        out = res = tuple(torch.empty(R, dtype=p.dtype, device=dev)
                          for p in part)
        occ = None
    err = fn(_ptr(scene.tri_p), T, *map(_ptr, rays), R, S,
             int(scene.has_motion), int(any_hit), *map(_ptr, part),
             *map(_ptr, res), _ptr(occ), cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, 'pr11 brute_force')
    return out


def sorted_query(scene, rays, any_hit):
    """The committed kernel on the rays in the chunk walk's sort order
    (over the box of the scene's vertices), its outputs in the rays' own
    order."""
    from langevin_mcmc_tpu_torch.ops import intersect
    from langevin_mcmc_tpu_torch.ops.chunkwalk import _sort_rays
    v = scene.tri_p.reshape(-1, 3)
    order = _sort_rays(v.min(0)[0], v.max(0)[0], rays[0], rays[1],
                       alive=rays[4] >= rays[3])
    out = intersect.brute_force(scene, *(x[order] for x in rays),
                                any_hit=any_hit)
    unsort = lambda x: torch.empty_like(x).index_copy_(0, order, x)
    return unsort(out) if any_hit else tuple(map(unsort, out))


def points_of(libs, scenes, rays, any_hit):
    """name -> a call of that point on these rays."""
    from langevin_mcmc_tpu_torch.ops import intersect
    sc = scenes['committed']
    out = {'pr11': lambda: parent_call(libs['pr11'].brute_force, sc, rays,
                                       any_hit),
           'committed': lambda: intersect.brute_force(sc, *rays,
                                                      any_hit=any_hit),
           'sorted': lambda: sorted_query(sc, rays, any_hit)}
    for q in ('q2e-3', 'q8e-3'):
        out[q] = (lambda s=scenes[q]: intersect.brute_force(
            s, *rays, any_hit=any_hit))
    for name in DIVISION:
        def call(lib=libs[name]):
            with library(lib):
                return intersect.brute_force(sc, *rays, any_hit=any_hit)
        out[name] = call
    return out


def equal(got, want, any_hit):
    if any_hit:
        return torch.equal(got, torch.isfinite(want[0]))
    return all(torch.equal(a, b) for a, b in zip(got, want))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('brute_designs: needs a CUDA device')
    sys.path.insert(0, HERE)
    import chip_smoke
    from langevin_mcmc_tpu_torch.ops import brute_tiles, cuda_build, intersect
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    args = sys.argv[1:]
    root = args[args.index('--parent') + 1] if '--parent' in args \
        else os.path.join(HERE, '_checkout', 'parent')
    card = chip_smoke.card_line()
    print(f'card: {card}', flush=True)
    cuda_build.load_library()
    print(f'brute.cu ptxas:\n{cuda_build.build_info["ptxas"].get("brute.cu")}',
          flush=True)
    libs = {'pr11': build('pr11', csrc=parent_csrc(root))}
    libs['pr11'].brute_force.argtypes = _PARENT_SIG
    for name, new in DIVISION.items():
        libs[name] = build(name, [('tri.cuh', _DIV, new)])
    results = []
    for tag, kw in (('motion', dict(scene='open', motion=True)),
                    ('box', {})):
        xml = chip_smoke.write_flagship(os.path.join(OUT, tag), **kw)
        sc = parse_scene(xml, device='cuda')[0]
        if not sc.has_motion:
            sc = brute_tiles.attach(sc)     # LMCMC_ISECT_BACKEND=brute's
        scenes = {'committed': sc,
                  'q2e-3': with_q_min(sc, 2e-3),
                  'q8e-3': with_q_min(sc, 8e-3)}
        if tag == 'motion':
            full = chip_smoke.motion_rays(sc, 65536, seed=23)
            sets = [(n, tuple(x[:n].contiguous() for x in full))
                    for n in (65536, chip_smoke.LARGE_RAYS)]
        else:
            org, d, mn, mx = chip_smoke.kernel_rays(sc, 65536, seed=7)
            sets = [(65536, (org, d, torch.zeros_like(mn), mn, mx))]
        for n, rays in sets:
            want = intersect._bruteforce_live(sc, *rays)
            st = brute_tiles.query_stats(sc, *rays)
            print(f'{tag} {n} rays: {st["list_mean"]:.1f} / '
                  f'{st["list_p99"]:.0f} tiles on a block\'s list (mean / '
                  f'p99) of {st["tiles"]}; the rays test {st["tested"]} '
                  f'pairs of {st["pairs_all"]} (live rays x triangles), '
                  f'{st["tested"] / max(st["pairs_all"], 1):.4f}; '
                  f'{st["full"]} full rays', flush=True)
            for any_hit in (False, True):
                points = points_of(libs, scenes, rays, any_hit)
                same = {}
                for name, fn in points.items():
                    same[name] = equal(fn(), want, any_hit)
                    if not same[name] and name not in DIVISION:
                        raise AssertionError(f'{tag} {n} any_hit={any_hit} '
                                             f'{name}: differs from the '
                                             f'plain version')
                ms = {name: [] for name in points}
                for name in list(points) + list(points)[::-1]:
                    ms[name].append(chip_smoke.cuda_ms_launches(
                        points[name]))
                ms = {k: sum(v) / len(v) for k, v in ms.items()}
                line = ', '.join(f'{k} {v:.4f}' for k, v in ms.items())
                print(f'{tag} {n} rays {"any" if any_hit else "closest"} '
                      f'(ms): {line}; rcp_rn equal: {same["rcp_rn"]}, '
                      f'rcp_approx equal: {same["rcp_approx"]}', flush=True)
                results.append(dict(scene=tag, rays=n, any_hit=any_hit,
                                    ms=ms, equal=same, stats=st))
        del sc, scenes
    summary = dict(card=card, results=results)
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'brute_designs.json'),
              'w') as f:
        json.dump(summary, f)


if __name__ == '__main__':
    main()
