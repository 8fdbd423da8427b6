"""Where the port's MCMC chain step spends its time on a GPU.

    python3 profile_torch.py [--time-only] [CONFIG ...]

CONFIG (no CONFIG: box, open and cache):

  box         the flagship box, path A of chip_smoke.py;
  open        the open scene, path D;
  cache       path E, the box with multiplexed and cache-seeded large
              steps and light coordinates, its cache rows pre-filled from
              the seed states as in chip_smoke.py's cache phase, so the
              cache branch runs;
  cache_cold  path E's configuration without the pre-fill;
  mmlt        the box with multiplexed large steps;
  mmlt_lc     the box with multiplexed large steps and light coordinates;
  motion      the open scene with --motion, path F: every ray query is the
              motion brute force (stage intersect_bruteforce, which the
              any-hit queries call too), no bake;
  iso         the box with the isotropic-only chain, path G;
  bvh         path F's moving open scene with a BVH attached (attach_bvh),
              path I: every ray query is the BVH kernel (stage traverse,
              the wrapper; the kernel's device time and share of the
              step's device time are printed from the profile).
Each is MALA (iso: the isotropic small step) at 1024x768, maxdepth 8,
65,536 chains, with a 65,536-sample bootstrap. The chain step is warmed
up and timed over 3 steps (no syncs); with --time-only that is all,
else:
  1. times each stage of the step inclusively over 3 steps (host clock
     with a device sync around every call of the wrapped functions). A
     stage is wrapped by replacing its module attribute, so the timer sees
     the calls that look the name up in that module when they run
     (mod.fn(...), or fn(...) inside mod), not names bound elsewhere at
     import time (from mod import fn). The chunk walk's stages: sort_rays
     (torch: pad, sort) and walk_staged (the kernel, which builds its own
     chunk lists); walk_resident is the resident form's;
  2. profiles 3 further steps with torch.profiler and prints the CUDA
     kernels by total device time, and their sum over the step time measured
     without syncs or profiler (the device-busy share);
  3. the same step captured (make_mlt_multi_step, n_inner 3): the graphs a
     step, the eager calls between them and the graphs' nodes, the
     synchronised ms of one replayed iteration (over one call of 3
     replays), and the kernels' device time an iteration over a profiled
     call of replays, over that replayed iteration's ms (the captured
     step's busy share, as 2 takes the eager step's), beside the eager
     step's numbers of 1 and 2.
Prints one JSON line with all three after each scene's.
"""

import collections
import functools
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
INIT_SAMPLES = 65536
STEPS = 3


def main():
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch: needs a CUDA device')
    sys.path.insert(0, HERE)
    import chip_smoke
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f'card: {card}', flush=True)
    cache = dict(scene='box', large_step='cache', light_coords=True)
    configs = {'box': dict(scene='box'), 'open': dict(scene='open'),
               'cache': cache, 'cache_cold': cache,
               'mmlt': dict(scene='box', large_step='multiplexed'),
               'mmlt_lc': dict(scene='box', large_step='multiplexed',
                               light_coords=True),
               'motion': dict(scene='open', motion=True),
               'iso': dict(scene='box', kernel='iso'),
               'bvh': dict(scene='open', motion=True)}
    args = sys.argv[1:]
    time_only = '--time-only' in args
    chosen = [a for a in args if a != '--time-only'] or ['box', 'open',
                                                         'cache']
    for name in chosen:
        print(f'scene: {name}', flush=True)
        xml = chip_smoke.write_flagship(
            os.path.join(HERE, 'smoke_out', 'profile', name),
            num_init_samples=INIT_SAMPLES, **configs[name])
        profile_scene(xml, name, card, prefill=name == 'cache',
                      time_only=time_only, attach=name == 'bvh')


def profile_scene(xml, label, card, prefill=False, time_only=False,
                  attach=False):
    """The stage and kernel breakdowns of one configuration's chain step
    (prefill: the cache rows pre-filled from the seed states;
    time_only: the unsynchronised step time alone; attach: a BVH
    attached, so every query takes the BVH kernel)."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.integrators import mlt
    from langevin_mcmc_tpu_torch.mcmc import chain, cache
    from langevin_mcmc_tpu_torch.path import replay, trace
    from langevin_mcmc_tpu_torch.ops import bvh, chunkwalk, intersect
    import chip_smoke

    scene, opts, _ = parse_scene(xml, device='cuda')
    if attach:
        scene = bvh.attach_bvh(scene)
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.no_grad():
        b, length_dist, banked = mlt.bootstrap(scene, opts, gen,
                                               chunk=chip_smoke.CHUNK)
        init = banked
        banked = mlt.attach_cache(banked, opts)
        if prefill:
            banked = chip_smoke.prefill_cache(banked, opts)
        step = mlt.make_mlt_step(scene, opts, b,
                                 opts.large_step_probability,
                                 length_dist=length_dist)
        frame = torch.zeros((scene.height, scene.width, 3), device='cuda')
        for _ in range(2):
            banked = step(gen, banked, frame, init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            banked = step(gen, banked, frame, init)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0) / STEPS
        print(f'step: {plain_ms:.1f} ms (no syncs, no profiler)')
        if time_only:
            print(json.dumps(dict(card=card, scene=label, steps=STEPS,
                                  step_ms=plain_ms)), flush=True)
            return

        # 1. inclusive stage times (synchronised)
        totals = collections.defaultdict(float)
        calls = collections.Counter()
        stages = [(chain, 'large_step'), (chain, 'large_step_multiplexed'),
                  (chain, 'large_step_cache'), (chain, 'small_step_mala'),
                  (chain, 'small_step_iso'),
                  (chain, '_perturb_and_grad'), (replay, 'replay_path'),
                  (replay, 'path_grad'), (replay, 'bake_frozen'),
                  (trace, 'generate_path_bidir'),
                  (trace, 'generate_subpath'), (cache, 'query_knn'),
                  (cache, 'eval_pdf_cache'), (cache, 'sample_cache'),
                  (cache, 'push_batch'), (chunkwalk, 'sort_rays'),
                  (chunkwalk, 'walk_staged'), (chunkwalk, 'walk_resident'),
                  (intersect, 'intersect_bruteforce'), (bvh, 'traverse'),
                  (mlt, 'splat')]
        saved = []
        for mod, name in stages:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                totals[_name] += time.perf_counter() - t0
                calls[_name] += 1
                return out
            setattr(mod, name, functools.wraps(fn)(timed))
        t0 = time.perf_counter()
        for _ in range(STEPS):
            banked = step(gen, banked, frame, init)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        stage_ms = {k: 1e3 * v / STEPS for k, v in totals.items()}
        print(f'synchronised step: {1e3 * wall / STEPS:.1f} ms')
        for k, v in sorted(stage_ms.items(), key=lambda kv: -kv[1]):
            print(f'  {k:24s} {v:10.1f} ms/step  '
                  f'({calls[k] / STEPS:.0f} calls/step)')

        # 2. torch.profiler window, no syncs inserted
        from torch.profiler import profile, ProfilerActivity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                banked = step(gen, banked, frame, init)
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    busy = dev_total / STEPS / plain_ms
    print(f'profiled window: {1e3 * window / STEPS:.1f} ms/step wall '
          f'(profiler on), {dev_total / STEPS:.1f} ms/step device kernel '
          f'time = busy share {busy:.3f} of the unprofiled step, '
          f'{launches / STEPS:.0f} kernel launches/step')
    bvh_ms = sum(e.self_device_time_total for e in events
                 if 'bvh_kernel' in e.key) / 1e3 / STEPS
    if bvh_ms:
        print(f'BVH kernel: {bvh_ms:.2f} ms/step device time = '
              f'{bvh_ms / (dev_total / STEPS):.4f} of the step\'s device '
              f'time, {bvh_ms / plain_ms:.4f} of the unprofiled step')
    cap = captured(scene, opts, b, length_dist, gen, banked, frame, init)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / STEPS
        rows.append(dict(name=e.key[:80], ms_per_step=ms,
                         calls_per_step=e.count / STEPS))
        print(f'  {ms:9.2f} ms/step {e.count / STEPS:7.0f}x  '
              f'{e.key[:90]}')
    print(json.dumps(dict(card=card, scene=label, steps=STEPS,
                          step_ms=plain_ms,
                          sync_step_ms=1e3 * wall / STEPS,
                          stage_ms=stage_ms,
                          window_step_ms=1e3 * window / STEPS,
                          device_ms=dev_total / STEPS,
                          busy_share=busy,
                          launches_per_step=launches / STEPS,
                          bvh_kernel_ms=bvh_ms,
                          top_kernels=rows, captured=cap)))


def captured(scene, opts, b, length_dist, gen, banked, frame, init):
    """Section 3: the step captured as CUDA graphs. Returns its numbers."""
    from langevin_mcmc_tpu_torch.integrators import mlt
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    with torch.no_grad():
        multi = mlt.make_mlt_multi_step(scene, opts, b,
                                        opts.large_step_probability, STEPS,
                                        length_dist=length_dist)
        banked, frame, _ = multi(gen, banked, frame, init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        banked, frame, n_done = multi(gen, banked, frame, init)
        torch.cuda.synchronize()
        replay_ms = 1e3 * (time.perf_counter() - t0) / STEPS
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            multi(gen, banked, frame, init)
            torch.cuda.synchronize()
        window = 1e3 * (time.perf_counter() - t0) / STEPS
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in events) / 1e3 / STEPS
    g = multi.graphs
    out = dict(graphs=len(g.graphs), eager_calls=len(g.calls),
               branches=len(g.branches), branch_runs=g.branch_runs,
               branch_skips=g.branch_skips,
               graph_nodes=sum(g.nodes), replay_ms=replay_ms,
               n_done=int(n_done), window_ms=window, device_ms=dev,
               busy_share=dev / replay_ms,
               kernels_per_step=sum(e.count for e in events) / STEPS,
               capture_s=g.capture_s, instantiate_s=g.instantiate_s)
    print(f'captured step: {out["graphs"]} graph(s), {out["eager_calls"]} '
          f'eager call(s), {out["branches"]} cond_call branch(es) (ran '
          f'{g.branch_runs}, skipped {g.branch_skips}), '
          f'{out["graph_nodes"]} nodes; {replay_ms:.1f} ms '
          f'an iteration (synchronised, replays; n_done {int(n_done)} of '
          f'{STEPS}); profiled: {window:.1f} ms an iteration, {dev:.1f} ms '
          f'device kernel time = busy share {out["busy_share"]:.3f}, '
          f'{out["kernels_per_step"]:.0f} kernels an iteration seen by the '
          f'profiler; capture {g.capture_s:.2f} s, instantiate '
          f'{g.instantiate_s:.2f} s', flush=True)
    return out


if __name__ == '__main__':
    main()
