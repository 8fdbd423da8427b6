"""capture_s: host seconds of the render's capturing iteration (the
multi-step's capture_pass_s: capture and instantiate of the chain step's
CUDA graphs, ops.graphs), between two device syncs. Part of
render_start_s. Nothing to read where no step was captured (the CPU)."""


def read(ctx):
    return ctx['capture_s']
