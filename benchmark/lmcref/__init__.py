"""The benchmark's plain reference of langevin_mcmc_tpu_torch: a frozen
copy of the port's plain PyTorch versions of the scene parser, the path
records, generation and replay (perturb and frozen, path_grad), the BSDFs,
lights and textures, with every ray query the plain brute force. It
imports nothing of the port, builds no acceleration table and launches no
hand-written kernel, so a later change to the port cannot move it.
"""
