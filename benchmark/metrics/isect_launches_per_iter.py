"""isect_launches_per_iter: executions of the port's ray-query kernels in
the window (the launch counters of ops.chunkwalk, ops.sweep_isect,
ops.bvh and ops.intersect, which count a captured launch at every
replay), over the window's iterations. Nothing to read where no kernel
launched (the CPU runs the plain versions)."""


def read(ctx):
    n = sum(ctx['launches'].values())
    return n / ctx['iterations'] if n else None
