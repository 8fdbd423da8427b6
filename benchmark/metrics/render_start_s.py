"""render_start_s: host seconds of the render's start as render_mlt
starts it: the bootstrap (integrators.mlt bootstrap), the direct pass and
the first multi-step call (eager warm-up, capture, replays), each ending
in a device sync, after the kernel library is loaded. Part of setup_s."""


def read(ctx):
    return ctx['render_start_s']
