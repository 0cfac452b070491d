"""Triclinic periodic cell: basis, reciprocal basis, minimum image.

Rebuild of the reference's PBC layer (SURVEY.md §2 "PBC/cell",
src/main/pbc.c [M placement]): a 3x3 row-vector basis, its reciprocal,
cell volume, the safe cutoff = half the minimum perpendicular cell width,
and minimum-image via the fractional-coordinate round trip.

Conventions: ``box`` is a (3,3) array whose ROWS are the cell vectors, so a
cartesian position is ``frac @ box``.  All functions are pure and jit-safe.
"""
from __future__ import annotations

import jax.numpy as jnp


def cell_volume(box):
    """Cell volume |det(box)| in A^3."""
    return jnp.abs(jnp.linalg.det(box))


def reciprocal_basis(box):
    """Rows are reciprocal-lattice vectors k_i with b_i . k_j = 2 pi delta_ij.

    With row-vector convention (r = f @ box), k-vectors for integer triples n
    are ``n @ reciprocal_basis(box)``.
    """
    return 2.0 * jnp.pi * jnp.linalg.inv(box).T


def inv_box(box):
    return jnp.linalg.inv(box)


def min_perpendicular_width(box):
    """Minimum distance between opposite cell faces.

    For each axis i, the perpendicular width is V / |b_j x b_k|.  The safe
    spherical cutoff is half of the minimum width (SURVEY.md §2 "PBC/cell").
    """
    v = cell_volume(box)
    c01 = jnp.linalg.norm(jnp.cross(box[0], box[1]))
    c12 = jnp.linalg.norm(jnp.cross(box[1], box[2]))
    c20 = jnp.linalg.norm(jnp.cross(box[2], box[0]))
    return jnp.min(jnp.stack([v / c12, v / c20, v / c01]))


def default_cutoff(box):
    """Half the minimum perpendicular cell width (the reference's default)."""
    return 0.5 * min_perpendicular_width(box)


def _apply33(v, m):
    """v @ m for last-axis-3 arrays, unrolled into component arithmetic.

    A tiny matmul would go to a matrix unit, which may run reduced-
    precision passes (TF32 on a GPU by default — corrupts coordinates)
    and is wasted on a 3x3 contraction; explicit multiplies are exact
    and fuse with the surrounding elementwise work."""
    return jnp.stack(
        [v[..., 0] * m[0, a] + v[..., 1] * m[1, a] + v[..., 2] * m[2, a]
         for a in range(3)], axis=-1)


def min_image(dr, box, box_inv=None):
    """Minimum-image displacement(s) for raw displacement(s) ``dr``.

    Exact for any cutoff <= half the minimum perpendicular width.  ``dr`` may
    have any leading batch shape, last axis = 3.
    """
    if box_inv is None:
        box_inv = jnp.linalg.inv(box)
    frac = _apply33(dr, box_inv)
    frac = frac - jnp.round(frac)
    return _apply33(frac, box)


def wrap_positions(pos, box, box_inv=None):
    """Wrap cartesian positions into the primary cell [0,1)^3 in fractional."""
    if box_inv is None:
        box_inv = jnp.linalg.inv(box)
    frac = pos @ box_inv
    frac = frac - jnp.floor(frac)
    return frac @ box


def wrap_molecules(pos, box, com, box_inv=None):
    """Wrap rigid molecules by their center of mass (keeps molecules intact).

    ``com`` has the same leading shape as ``pos``; every atom is shifted by
    the wrap displacement of its molecule's COM.
    """
    if box_inv is None:
        box_inv = jnp.linalg.inv(box)
    frac = com @ box_inv
    shift = (jnp.floor(frac)) @ box
    return pos - shift


def abc_from_cell(box):
    """(a, b, c, alpha, beta, gamma[deg]) from a row-vector basis —
    the CRYST1 record contents (host-side numpy)."""
    import numpy as onp
    box = onp.asarray(box, onp.float64)
    a, b, c = (onp.linalg.norm(box[i]) for i in range(3))
    cosa = box[1] @ box[2] / (b * c)
    cosb = box[0] @ box[2] / (a * c)
    cosg = box[0] @ box[1] / (a * b)
    return (float(a), float(b), float(c),
            float(onp.degrees(onp.arccos(onp.clip(cosa, -1, 1)))),
            float(onp.degrees(onp.arccos(onp.clip(cosb, -1, 1)))),
            float(onp.degrees(onp.arccos(onp.clip(cosg, -1, 1)))))


def cell_from_abc(a, b, c, alpha_deg, beta_deg, gamma_deg):
    """Build a row-vector cell basis from lengths + angles (degrees).

    Standard crystallographic convention: a along x, b in the xy plane.
    Mirrors the reference's ``abcbasis`` option (SURVEY.md §2.9 "Cell").
    """
    alpha = jnp.deg2rad(alpha_deg)
    beta = jnp.deg2rad(beta_deg)
    gamma = jnp.deg2rad(gamma_deg)
    bx = b * jnp.cos(gamma)
    by = b * jnp.sin(gamma)
    cx = c * jnp.cos(beta)
    cy = c * (jnp.cos(alpha) - jnp.cos(beta) * jnp.cos(gamma)) / jnp.sin(gamma)
    cz = jnp.sqrt(jnp.maximum(c * c - cx * cx - cy * cy, 0.0))
    z = jnp.zeros_like(jnp.asarray(a))
    return jnp.stack([
        jnp.stack([jnp.asarray(a), z, z]),
        jnp.stack([bx, by, z]),
        jnp.stack([cx, cy, cz]),
    ])
