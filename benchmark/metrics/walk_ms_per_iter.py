"""walk_ms_per_iter: device milliseconds of the chunk walk's kernels
(walk_kernel and merge_kernel, csrc/walk.cuh) in the profiled call, over
its iterations. Nothing to read where they did not run."""


def read(ctx):
    tr = ctx['trace']
    if tr is None:
        return None
    s = tr.kernel_seconds('walk_kernel', 'merge_kernel')
    return s * 1e3 / ctx['n_inner'] if s > 0 else None
