"""The one place that decides whether a pass runs a hand-written kernel.

Production code asks ``thole_kernel(cfg)``; nothing else — no module
global, no backend test elsewhere — chooses between the Triton kernel
(ops/pallas/thole_kernel.py) and the jnp reference (ops/thole.py).
"""
from __future__ import annotations

import jax


def thole_kernel(cfg, interpret: bool = False) -> bool:
    """True when the Thole static field / SCF dipole matvec runs through
    the Pallas-Triton kernel.

    - On a GPU backend: when ``thole_kernel.supported(cfg)`` (f32, a
      known damping model).
    - On any other backend: never — XLA compiles the jnp reference.
    - ``interpret=True`` is for tests only: it engages the kernel in
      Pallas interpret mode wherever the configuration is supported, so
      the CPU suite exercises the kernel's arithmetic and the culled
      solve.
    - Inside the spatially sharded MC step (``cfg.spatial_axis``) the
      row-sharded jnp passes run instead (thole._rowblock_scan).
    """
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    if cfg.spatial_axis is not None or not tk.supported(cfg):
        return False
    return interpret or jax.default_backend() == "gpu"
