"""The benchmark of langevin_mcmc_tpu_torch on one NVIDIA H100.

One run drives one cell of BENCHMARK.json: the cell's scene is written
from its configuration file (configs/<config>.json) by the frozen scene
generator (scenegen.py), the render starts as the port's render_mlt
starts it (bootstrap, direct pass, the first call of the CUDA-graph
multi-step), the window calls the multi-step until its seconds are up,
and the plain reference (lmcref) judges what the window left behind
(check.py). The cell's traffic (the small-step kernel, the large-step
kind, n_inner, optional set-up steps and the limits of its check) is
workloads/<cell>.json; each per-layer metric is a reader of its own,
metrics/<name>.py. Nothing here imports JAX or the JAX package.
"""
