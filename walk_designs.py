"""Design points of the walk kernel (csrc/walk.cuh) beside the committed
kernel, on one GPU, at the flagship scene's 65,536 kernel rays and at the
large step's 4,261 (padded to 4,352):

    python3 walk_designs.py

Each design point is a patched copy of langevin_mcmc_tpu_torch/csrc/
(cuda_build.build_copy), built under smoke_out/walk_designs/ (git-ignored),
so the committed kernel
carries no switch for it:
  * committed: the sources as they are;
  * whole_chunk: the sweep (K4) stages whole 512-triangle chunks, a ring of
    two 28 KB buffers in dynamic shared memory, instead of 128-triangle
    tiles (only csrc/sweep.cu is built);
  * two_ctas: __launch_bounds__(256) with no minimum of CTAs an SM, so
    that ptxas picks the registers (102 for the sweep, two CTAs an SM).
Each build prints ptxas's registers and shared memory per kernel. Every
point is first checked equal to the committed kernel bit for bit,
then timed (CUDA events, median of 20 after a warm-up), the committed
kernel before and after the others. The staged form (K1/K2) against the
resident one (K3) on the same inputs is a shared-memory stage against
__ldg reads; S = 1 against the default S is in chip_smoke.py's S tables.
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'smoke_out', 'walk_designs')

_RING = '  __shared__ Stage s_stage[Form::kResident ? 1 : kStages];'
_DYN = ('  extern __shared__ __align__(16) unsigned char s_dyn[];\n'
        '  Stage* s_stage = reinterpret_cast<Stage*>(s_dyn);')


def _dyn_launch(any_hit):
    a = 'true' if any_hit else 'false'
    return (f'walk_kernel<Form, {a}><<<grid, kRayBlock, 0, s>>>(',
            f'cudaFuncSetAttribute(walk_kernel<Form, {a}>, '
            f'cudaFuncAttributeMaxDynamicSharedMemorySize, '
            f'kStages * sizeof(Stage));\n'
            f'  walk_kernel<Form, {a}><<<grid, kRayBlock, '
            f'kStages * sizeof(Stage), s>>>(')


# name: (sources built, [(text, replacement) in walk.cuh])
DESIGNS = {
    'committed': (('chunkwalk.cu', 'sweep.cu'), []),
    'whole_chunk': (('sweep.cu',), [
        ('constexpr int kTile = 128;', 'constexpr int kTile = 512;'),
        (_RING, _DYN), _dyn_launch(True), _dyn_launch(False)]),
    'two_ctas': (('chunkwalk.cu', 'sweep.cu'), [
        ('__launch_bounds__(kRayBlock, kCtasPerSm)',
         '__launch_bounds__(kRayBlock)')]),
}


def build(name):
    """Patch a copy of csrc/ and build it; returns the bound library."""
    from langevin_mcmc_tpu_torch.ops import cuda_build
    sources, patches = DESIGNS[name]
    print(f'design {name}: ptxas (registers, shared memory):', flush=True)
    lib, reports = cuda_build.build_copy(
        os.path.join(OUT, name), [('walk.cuh', a, b) for a, b in patches],
        sources=sources)
    for text in reports.values():
        print(text, end='', flush=True)
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit('walk_designs: needs a CUDA device')
    sys.path.insert(0, HERE)
    import chip_smoke
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import cuda_build
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene

    print(f'card: {chip_smoke.card_line()}', flush=True)
    libs = {name: build(name) for name in DESIGNS}
    xml = chip_smoke.write_flagship(os.path.join(OUT, 'flagship'))
    scene = parse_scene(xml, device='cuda')[0]
    org, d, mn, mx = chip_smoke.kernel_rays(scene, 65536, seed=7)
    large = int(0.05 * 65536 * 1.3) + 1
    forms = (('staged', 'chunkwalk_staged', scene.cw, cw.sort_rays),
             ('resident', 'chunkwalk_resident', scene.cw, cw.sort_rays),
             ('sweep', 'sweep_walk', scene.sweep, sw.prepare_rays))
    order = ['committed'] + [n for n in DESIGNS if n != 'committed'] \
        + ['committed']
    for n in (65536, large):
        for form, entry, tab, sort in forms:
            rays = sort(tab, org[:n], d[:n], mn[:n], mx[:n])[0]
            args = (tab.pack.shape[2], tab.pack, tab.ids, tab.chunk_lo,
                    tab.chunk_hi, *rays)
            ref = None
            for name in order:
                if not hasattr(libs[name], entry):
                    continue
                cuda_build._lib = libs[name]
                fns = [lambda a=a: cw.launch(entry, *args, a)
                       for a in (False, True)]
                got = [fn() for fn in fns]
                if ref is None:
                    ref = got
                for a in (False, True):
                    chip_smoke.compare(f'{name} {form}', got[a], ref[a], a)
                ms = [chip_smoke.cuda_ms(fn, repeats=20) for fn in fns]
                print(f'design {name}: {form}, {rays[0].shape[0]} rays: '
                      f'closest {ms[0]:.3f} ms, any {ms[1]:.3f} ms',
                      flush=True)
    cuda_build._lib = None
    print('every design point equal to the committed kernel bit for bit')


if __name__ == '__main__':
    main()
