"""bootstrap_s: host seconds of the port's bootstrap (integrators.mlt
bootstrap: the 300,000 generated paths, b and the seed chains), between
two device syncs. Part of render_start_s."""


def read(ctx):
    return ctx['spans']['bootstrap_s']
