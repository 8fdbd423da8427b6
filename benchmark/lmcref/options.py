"""Renderer options.

Mirrors the reference option set (reference src/dptoptions.h:7-34) plus the
compile-time constants the reference hides in #defines
(src/mutation.h:5-8, src/mala.h:9-13, src/global_cache.h:8-14), so every
knob is discoverable and serializable in one place.
"""

import dataclasses


@dataclasses.dataclass
class Options:
    # --- core run configuration (dptoptions.h:8-14) ---
    integrator: str = "mcmc"           # "mc" or "mcmc"
    bidirectional: bool = True
    spp: int = 256
    num_init_samples: int = 300000
    min_depth: int = -1
    max_depth: int = 8
    direct_spp: int = 256

    # --- mutation kernels (dptoptions.h:16-25) ---
    h2mc: bool = False                  # Hessian-based H2MC proposals
    perturb_std_dev: float = 0.01       # isotropic/H2MC small-step sigma
    roughness_threshold: float = 0.05
    large_step_probability: float = 0.05
    large_step_prob_scale: float = 1.0
    mala: bool = False                  # MALA/LMC proposals
    mala_gn: float = 100.0              # truncated-drift gradient norm bound
    mala_stepsize: float = 0.005
    mala_std_dev: float = 0.005         # shrink prior sigma
    sample_from_global_cache: bool = False
    # TPU deviation knob (no reference analogue): fraction of chains
    # budgeted per step for the expensive current-side gradient/Hessian
    # (the reference evaluates it on the few !gaussianInitialized lanes,
    # mutation_mala.h:83-135). Overflow lanes propose from the one-shot
    # isotropic fallback (MH-correct via cur_ok). Quality/throughput
    # tradeoff: was hardcoded 0.25 in r2, 0.125 in r3
    cur_grad_fraction: float = 0.125
    # Sparse cache-phase kNN budget (TPU deviation, same pattern as
    # cur_grad_fraction): at most this fraction of lanes runs the MXU kNN
    # sweep per step — lanes passing the PSS_REUSE_DIST test reuse their
    # last query (mutation_mala.h:131-164); overflow lanes fall back to
    # the isotropic kernel for one proposal (MH-correct)
    cache_query_fraction: float = 0.25

    # --- chains & misc (dptoptions.h:27-33) ---
    num_chains: int = 128
    seed_offset: int = 0
    report_interval_spp: int = 0
    discrete_std_dev: float = 0.01
    uniform_mixing_probability: float = 0.1
    use_light_coordinate_sampling: bool = False
    large_step_multiplexed: bool = False

    # --- outlier-removal constants (reference src/mutation.h:5-8) ---
    remove_outliers: bool = True
    outlier_weak_reject_cnt: int = 10000
    outlier_strong_reject_cnt: int = 1000
    outlier_ratio_threshold: float = 30.0

    # --- MALA constants (reference src/mala.h:9-13) ---
    pcd_min: float = 0.01
    pcd_max: float = 100.0
    mtm_min: float = -5.0
    mtm_max: float = 5.0
    ls_ratio: float = 0.1

    # --- global PSS cache constants (reference src/global_cache.h:8-14) ---
    pss_min_length: int = 2
    pss_max_length: int = 12
    pss_max_size: int = 3000
    pss_knn: int = 5
    pss_query_dist: float = 0.01
    pss_reuse_dist: float = 0.10
    cache_prob: float = 0.5
    cache_sig: float = 0.15

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
