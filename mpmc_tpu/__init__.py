"""mpmc_tpu — molecular Monte Carlo on an accelerator, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of MPMC
(smann95/mpmc): rigid-molecule NVT/NPT/uVT Monte Carlo of gas sorption in
porous materials with LJ / repulsion-dispersion potentials, Ewald
electrostatics, Thole-Applequist polarization solved self-consistently,
Feynman-Hibbs quantum corrections, fugacity-driven GCMC, and
parallel-tempering replicas over a device mesh.  It runs on NVIDIA GPUs
(the Thole SCF matvec through a Pallas-Triton kernel) and on the CPU
(tests, float64 parity runs).

Design (SURVEY.md §7): pure functional state on padded arrays with alive
masks, masked O(N^2) tile kernels, lax.scan Metropolis, threefry PRNG,
shard_map replica parallelism.
"""

__version__ = "0.1.0"

import jax as _jax

# On a GPU, XLA may run f32 matmuls in TF32 (about three decimal
# digits) by default — that is ~1e-3 relative error on *coordinates*
# when the minimum-image transform or the Ewald phase k.r goes through
# a matmul, which corrupts every energy at that level.  Physics code
# needs true f32 contractions everywhere.
_jax.config.update("jax_default_matmul_precision", "float32")

from mpmc_tpu import constants  # noqa: F401
