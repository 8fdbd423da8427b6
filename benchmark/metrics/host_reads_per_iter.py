"""host_reads_per_iter: the cond_call branches a captured step ran or
skipped in the window (ops.graphs StepGraphs.branch_runs + branch_skips),
each one host read of its flag, over the window's iterations. Nothing to
read where no step was captured."""


def read(ctx):
    if ctx['host_reads'] is None:
        return None
    return ctx['host_reads'] / ctx['iterations']
