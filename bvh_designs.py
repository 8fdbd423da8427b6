"""Design points of the BVH traversal kernel (csrc/bvh.cu), and an
earlier tree's kernel beside it, on one GPU:

    python3 bvh_designs.py [--parent DIR]

On the flagship box, the open scene and the moving open scene (full
width, chip_smoke.write_flagship), with chip_smoke.py's BVH rays
(bvh_rays) at 65,536 rays and the large step's 4,260, closest and any
hit. Each point but the committed kernel is a patched copy of csrc/
(cuda_build.build_copy, built under smoke_out/bvh_designs/), so the
committed kernel carries no switch for it:
  * committed: csrc/bvh.cu as it is (64 threads a block);
  * t32, t128, t256: kThreads, the block size, set to 32, 128 or 256;
  * if_if: the loop takes one node a round, inner or leaf, instead of
    the committed while-while loop;
  * stack_pop: an inner step pushes every child hit (the right one
    first) and pops the next node, as traverse_reference does, instead
    of keeping the next node in a register;
  * prims: a leaf's triangles read through the prim ids (prims[first +
    k], then that triangle's three float4 in triangle order) instead of
    in leaf order;
  * edges (static scenes): the table holds p0, e1 = p1 - p0 and e2 =
    p2 - p0 (the subtractions rounded by torch as the kernel rounds
    them) and the test reads the edges instead of subtracting;
  * top255, top1023: the first 255 or 1,023 breadth-first records (the
    top 8 or 10 levels) copied into shared memory at block start and
    read from there;
  * with --parent DIR, parent: the kernel before the packed tables
    (DIR/langevin_mcmc_tpu_torch/csrc/bvh.cu, one thread a ray, 128 a
    block, walking the [N, 8] nodes and prim ids).
Every point is first checked equal to traverse_reference bit for bit,
then timed with CUDA events (chip_smoke.cuda_ms_launches: 20 calls back
to back, median of 5): each point twice, the points in one order and
then in the reverse order; the mean of the two medians is reported.
Prints ptxas's report of each build, a line per row and one JSON line,
which is also written to chiprun_out/bvh_designs.json.
"""

import ctypes
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'smoke_out', 'bvh_designs')
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier kernel's entry point: nodes, prim ids, vertices and rays,
# (rays, triangles, motion, any_hit), the closest hit's outputs, occluded,
# the stream
_PARENT_SIG = [_P] * 8 + [_I] * 4 + [_P] * 5 + [_P]

_BLOCK = 'constexpr int kThreads = 64;'
_LEAF_CONST = 'constexpr int kMaxLeaf = 4;       // ops/bvh.py MAX_LEAF\n'
_IF_IF = [('    while (node >= 0) {\n', '    if (node >= 0) {\n'),
          ('    while (!done && node < 0) {\n', '    else if (node < 0) {\n')]
_STACK_POP = [("""      if (lhit) {
        if (rhit) stack[sp++] = __float_as_int(e.y);
        node = __float_as_int(e.x);
      } else if (rhit) {
        node = __float_as_int(e.y);
      } else if (sp > 0) {
""", """      if (rhit) stack[sp++] = __float_as_int(e.y);
      if (lhit) stack[sp++] = __float_as_int(e.x);
      if (sp > 0) {
""")]
# the prim ids, set once per scene through bvh_set_prims
_PRIMS = [
    (_LEAF_CONST, _LEAF_CONST + '__device__ const int* g_prims;\n'),
    ('                                         int j, float time, float4 '
     'v[3]) {\n',
     '                                         int j, float time, float4 '
     'v[3]) {\n  j = __ldg(g_prims + j);\n'),
    ('#undef LMCMC_BVH_LAUNCH\n}\n',
     '#undef LMCMC_BVH_LAUNCH\n}\n\nextern "C" int bvh_set_prims(const int* '
     'p) {\n  return static_cast<int>(cudaMemcpyToSymbol(g_prims, &p, '
     'sizeof(p)));\n}\n')]
_EDGES = [(
    '  const float e1[3] = {v[1].x - v[0].x, v[1].y - v[0].y, v[1].z - '
    'v[0].z};\n  const float e2[3] = {v[2].x - v[0].x, v[2].y - v[0].y, '
    'v[2].z - v[0].z};\n',
    '  const float e1[3] = {v[1].x, v[1].y, v[1].z};\n'
    '  const float e2[3] = {v[2].x, v[2].y, v[2].z};\n')]
_LOADS = """      const float4 a = __ldg(records + 4 * node);
      const float4 b = __ldg(records + 4 * node + 1);
      const float4 c = __ldg(records + 4 * node + 2);
      const float4 e = __ldg(records + 4 * node + 3);
"""
_SMEM_LOADS = """      float4 a, b, c, e;
      if (node < kTop) {
        a = s_top[4 * node];
        b = s_top[4 * node + 1];
        c = s_top[4 * node + 2];
        e = s_top[4 * node + 3];
      } else {
        a = __ldg(records + 4 * node);
        b = __ldg(records + 4 * node + 1);
        c = __ldg(records + 4 * node + 2);
        e = __ldg(records + 4 * node + 3);
      }
"""
_KERNEL_START = '           unsigned char* __restrict__ occluded) {\n'
_COPY = """  extern __shared__ float4 s_top[];
  for (int i = threadIdx.x; i < 4 * kTop; i += blockDim.x)
    s_top[i] = __ldg(records + i);
  __syncthreads();
"""
_LAUNCH = '  bvh_kernel<kMotion, kAnyHit><<<grid, kThreads, 0, stream>>>('
_SMEM_LAUNCH = """  cudaFuncSetAttribute(bvh_kernel<kMotion, kAnyHit>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kTop * 64);
  bvh_kernel<kMotion, kAnyHit><<<grid, kThreads, kTop * 64, stream>>>("""


def _top(records):
    return [(_LEAF_CONST, f'{_LEAF_CONST}constexpr int kTop = {records};\n'),
            (_KERNEL_START, _KERNEL_START + _COPY), (_LOADS, _SMEM_LOADS),
            (_LAUNCH, _SMEM_LAUNCH)]


# name: [(text, replacement) in csrc/bvh.cu]
DESIGNS = {**{f't{t}': [(_BLOCK, f'constexpr int kThreads = {t};')]
              for t in (32, 128, 256)},
           'if_if': _IF_IF, 'stack_pop': _STACK_POP, 'prims': _PRIMS,
           'edges': _EDGES, 'top255': _top(255), 'top1023': _top(1023)}
TOP_MIN = 1023      # the records the scenes' trees must hold for top*


def build(name, patches, csrc=None):
    """csrc/ (or another tree's) with patches to bvh.cu, bvh.cu built
    alone under smoke_out/bvh_designs/name; its library."""
    from langevin_mcmc_tpu_torch.ops import cuda_build
    kw = {} if csrc is None else dict(csrc=csrc)
    lib, reports = cuda_build.build_copy(
        os.path.join(OUT, name), [('bvh.cu', a, b) for a, b in patches],
        sources=['bvh.cu'], **kw)
    print(f'{name} bvh.cu ptxas:\n{reports["bvh.cu"]}', flush=True)
    return lib


def _outputs(R, dev, any_hit):
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
        return occ, (None,) * 4, occ
    res = (torch.empty(R, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, device=dev), torch.empty(R, device=dev))
    return None, res, res


def _ptr(x):
    return None if x is None else x.data_ptr()


def variant_call(fn, scene, records, root, tris, rays, any_hit):
    """ops/bvh.traverse's launch, through a build's entry point, on these
    tables."""
    from langevin_mcmc_tpu_torch.ops import cuda_build
    R, dev = rays[0].shape[0], rays[0].device
    occ, res, out = _outputs(R, dev, any_hit)
    err = fn(_ptr(records), root, _ptr(tris), tris.shape[1],
             *map(_ptr, rays), R, int(scene.has_motion), int(any_hit),
             *map(_ptr, res), _ptr(occ), cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, 'variant bvh_traverse')
    return out


def parent_call(fn, scene, rays, any_hit):
    from langevin_mcmc_tpu_torch.ops import cuda_build
    R, dev = rays[0].shape[0], rays[0].device
    occ, res, out = _outputs(R, dev, any_hit)
    err = fn(*map(_ptr, (scene.bvh_nodes, scene.bvh_prim_ids, scene.tri_p)),
             *map(_ptr, rays), R, scene.num_tris, int(scene.has_motion),
             int(any_hit), *map(_ptr, res), _ptr(occ),
             cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, 'parent bvh_traverse')
    return out


def equal(got, want, any_hit):
    if any_hit:
        return torch.equal(got, torch.isfinite(want))
    return all(torch.equal(a, b) for a, b in zip(got, want))


def points_of(libs, scene, rays, any_hit):
    """name -> a call of that point on these rays."""
    from langevin_mcmc_tpu_torch.ops import bvh
    p = scene.bvh_packed
    T = scene.num_tris
    # triangle order (prims) and p0, e1, e2 (edges) beside leaf order
    tri_order = bvh.pack_bvh(scene.bvh_nodes,
                             torch.arange(T, dtype=torch.int32,
                                          device=p.tris.device),
                             scene.tri_p).tris
    edges = p.tris.clone()
    edges[:, :, 1:, :3] -= edges[:, :, :1, :3]
    tris = dict(prims=tri_order, edges=edges)
    out = {}
    for name, lib in libs.items():
        if name == 'parent':
            out[name] = lambda lib=lib: parent_call(lib.bvh_traverse, scene,
                                                    rays, any_hit)
        elif name != 'edges' or not scene.has_motion:
            out[name] = (lambda lib=lib, t=tris.get(name, p.tris):
                         variant_call(lib.bvh_traverse, scene, p.records,
                                      p.root, t, rays, any_hit))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('bvh_designs: needs a CUDA device')
    sys.path.insert(0, HERE)
    import chip_smoke
    from langevin_mcmc_tpu_torch.ops import bvh, cuda_build
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    args = sys.argv[1:]
    parent_root = args[args.index('--parent') + 1] if '--parent' in args \
        else None
    card = chip_smoke.card_line()
    print(f'card: {card}', flush=True)
    libs = {'committed': cuda_build.load_library()}
    print(f'bvh.cu ptxas:\n{cuda_build.build_info["ptxas"].get("bvh.cu")}',
          flush=True)
    libs.update({name: build(name, patches)
                 for name, patches in DESIGNS.items()})
    libs['prims'].bvh_set_prims.argtypes = [_P]
    if parent_root:
        libs['parent'] = build('parent', [], os.path.join(
            parent_root, 'langevin_mcmc_tpu_torch', 'csrc'))
        libs['parent'].bvh_traverse.argtypes = _PARENT_SIG
    results = []
    for tag, kw in (('box', {}), ('open', dict(scene='open')),
                    ('motion', dict(scene='open', motion=True))):
        xml = chip_smoke.write_flagship(os.path.join(OUT, tag), **kw)
        scene = bvh.attach_bvh(parse_scene(xml, device='cuda')[0])
        all_rays = chip_smoke.bvh_rays(tag, scene)
        tabs = (scene.bvh_nodes, scene.bvh_prim_ids, scene.tri_p)
        if scene.bvh_packed.records.shape[0] < TOP_MIN:
            raise AssertionError(f'{tag}: fewer records than top* copies')
        cuda_build.raise_on_error(
            libs['prims'].bvh_set_prims(_ptr(scene.bvh_prim_ids)),
            'bvh_set_prims')
        for n in (65536, chip_smoke.LARGE_RAYS):
            rays = tuple(x[:n].contiguous() for x in all_rays)
            for any_hit in (False, True):
                want = bvh.traverse_reference(*tabs, *rays, any_hit,
                                              scene.has_motion)
                points = points_of(libs, scene, rays, any_hit)
                for name, fn in points.items():
                    if not equal(fn(), want, any_hit):
                        raise AssertionError(f'{tag} {n} any_hit={any_hit} '
                                             f'{name}: differs from '
                                             f'traverse_reference')
                ms = {name: [] for name in points}
                for name in list(points) + list(points)[::-1]:
                    ms[name].append(chip_smoke.cuda_ms_launches(
                        points[name]))
                ms = {k: sum(v) / len(v) for k, v in ms.items()}
                line = ', '.join(f'{k} {v:.4f}' for k, v in ms.items())
                print(f'{tag} {n} rays {"any" if any_hit else "closest"} '
                      f'(ms): {line}', flush=True)
                results.append(dict(scene=tag, rays=n, any_hit=any_hit,
                                    ms=ms))
        del scene
    summary = dict(card=card, results=results)
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'bvh_designs.json'),
              'w') as f:
        json.dump(summary, f)


if __name__ == '__main__':
    main()
