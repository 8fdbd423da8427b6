"""eigh_ms_per_iter: device milliseconds of the eigendecomposition's
kernels (cuSOLVER's batched symmetric eigensolver behind
torch.linalg.eigh, run between the H2MC step's graphs by
mcmc/gaussian.py's _eigh) in the profiled call, over its iterations.
Nothing to read where they did not run."""

# the solver's kernels, by substrings of their names in the device trace
# of torch.linalg.eigh on [8,192, 16, 16] float32 batches (H100, torch
# 2.11+cu128: a divide-and-conquer syevd): the tridiagonal reduction
# (sytrd), its eigensolver (stedc, steqr, laed*), the back-transform
# (ormqr) and the scalings and copies around them; torch's own kernels
# around the call (cat, the info check) are not counted
EIGH_KERNELS = ('sytrd', 'stedc_params', 'laed2_copy', 'merge_ker<',
                'lansy_M_stage', 'lascl_kernel', 'ormqr_cta_kernel',
                'lacpy_kernel', 'scale_max<', 'cuds_scal_batch_kernel',
                'copy_info_kernel', 'xx_set_info_ker')


def read(ctx):
    tr = ctx['trace']
    if tr is None:
        return None
    s = tr.kernel_seconds(*EIGH_KERNELS)
    return s * 1e3 / ctx['n_inner'] if s > 0 else None
