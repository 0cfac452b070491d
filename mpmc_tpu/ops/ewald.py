"""Ewald summation: reciprocal-space, self, and Wolf terms.

Rebuild of the reference's electrostatics (SURVEY.md §2 "Ewald
electrostatics", src/energy/coulombic.c [C]).  The real-space erfc sum and
the intramolecular erf exclusion live in ops/pairs.py (they share the pair
tiles); this module owns the k-space machinery:

    U_recip = ke * (2 pi / V) sum_{k != 0} w_k exp(-k^2/4a^2)/k^2 |S(k)|^2
    S(k)    = sum_i alive_i q_i exp(i k . r_i)
    U_self  = -ke * a/sqrt(pi) * sum_i alive_i q_i^2

k-vectors are generated from a *static* integer half-space table (spherical
cutoff |n| <= kmax, lexicographic half-space, weight 2) so the structure
factor is one [N, Nk] matmul — matmul-shaped by construction (SURVEY.md §5
"Long-context analog": Ewald recip as batched dense matmuls).

The cached structure factor (sk_re, sk_im) enables O(A * Nk) delta updates
when one molecule moves — the functional analog of the reference's per-pair
energy caching for the k-space term.

Neutral-system convention: no uniform-background (charged-cell) correction
term is applied, matching typical MPMC usage on neutral frameworks.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from mpmc_tpu.constants import KE
from jax.scipy.special import erfc


@functools.lru_cache(maxsize=None)
def half_space_ints(kmax: int):
    """Static integer k-vector table: one of each +/-n pair, |n|<=kmax, n!=0."""
    rng = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    n2 = (n * n).sum(1)
    sphere = (n2 > 0) & (n2 <= kmax * kmax)
    half = ((n[:, 0] > 0)
            | ((n[:, 0] == 0) & (n[:, 1] > 0))
            | ((n[:, 0] == 0) & (n[:, 1] == 0) & (n[:, 2] > 0)))
    return np.ascontiguousarray(n[sphere & half], dtype=np.float64)


def kvectors(box, kmax: int):
    """[Nk,3] reciprocal vectors for the current (possibly traced) box."""
    ints = jnp.asarray(half_space_ints(kmax), box.dtype)
    recip = 2.0 * jnp.pi * jnp.linalg.inv(box).T
    return ints @ recip


@functools.lru_cache(maxsize=None)
def rect_ints(kmax: int):
    """Full-cube integer table [-kmax..kmax]^3 (n1-major C order, n=0
    included with zero weight) — the layout the separable matmul structure
    factor produces naturally."""
    rng = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    return np.ascontiguousarray(n, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def rect_weights(kmax: int):
    """Static per-k pair weights for the cube table: 1 inside the
    |n| <= kmax sphere (both half-spaces present explicitly), 0 at the
    origin and outside the sphere — same k-set as the half-space table,
    so the two representations give identical energies."""
    n = rect_ints(kmax)
    n2 = (n * n).sum(1)
    return ((n2 > 0) & (n2 <= kmax * kmax)).astype(np.float64)


def ktable(box, cfg):
    """(kvecs [Nk,3], pair_w [Nk]) in the configured representation:
    half-space (pair weight 2) or, with cfg.ewald_mxu, the full cube
    (sphere-masked weight 1) whose layout matches structure_factor_mxu.
    """
    recip = 2.0 * jnp.pi * jnp.linalg.inv(box).T
    if getattr(cfg, "ewald_mxu", False):
        ints = jnp.asarray(rect_ints(cfg.ewald_kmax), box.dtype)
        pw = jnp.asarray(rect_weights(cfg.ewald_kmax), box.dtype)
    else:
        ints = jnp.asarray(half_space_ints(cfg.ewald_kmax), box.dtype)
        pw = jnp.full((ints.shape[0],), 2.0, box.dtype)
    return ints @ recip, pw


def axis_phase_tables(t, kmax: int):
    """(re, im) [N, 2*kmax+1] of e^{i n t} for n = -kmax..kmax, built by
    complex-multiply recursion — 1 sin/cos per atom instead of one per
    (atom, k-vector)."""
    cr, ci = jnp.cos(t), jnp.sin(t)
    pr, pi = jnp.ones_like(t), jnp.zeros_like(t)
    pos_re, pos_im = [], []
    for _ in range(kmax):
        pr, pi = pr * cr - pi * ci, pr * ci + pi * cr
        pos_re.append(pr)
        pos_im.append(pi)
    re = ([p for p in reversed(pos_re)]
          + [jnp.ones_like(t)] + pos_re)
    im = ([-p for p in reversed(pos_im)]
          + [jnp.zeros_like(t)] + pos_im)
    return jnp.stack(re, -1), jnp.stack(im, -1)


def structure_factor_mxu(pos, charge, alive, box, kmax: int):
    """S(k) over the full cube table via separable phases:

        e^{i k.r} = e^{i n1 t1} e^{i n2 t2} e^{i n3 t3},
        t_a = (2 pi box^-T)_a . r,

    so the per-atom trig collapses to 3 sin/cos and the k sum becomes
    per-axis phase-table products contracted as matmuls (SURVEY.md §5:
    Ewald recip as batched dense matmuls).  Returns (re, im), each
    [(2 kmax+1)^3] flattened in rect_ints order."""
    recip = 2.0 * jnp.pi * jnp.linalg.inv(box).T
    t = pos @ recip.T                                   # [N,3]
    q = jnp.where(alive, charge, 0.0)
    p1r, p1i = axis_phase_tables(t[:, 0], kmax)
    p2r, p2i = axis_phase_tables(t[:, 1], kmax)
    p3r, p3i = axis_phase_tables(t[:, 2], kmax)
    q1r = q[:, None] * p1r
    q1i = q[:, None] * p1i
    # U[i,a,b] = (q P1)[i,a] * P2[i,b]   (complex)
    ur = q1r[:, :, None] * p2r[:, None, :] - q1i[:, :, None] * p2i[:, None, :]
    ui = q1r[:, :, None] * p2i[:, None, :] + q1i[:, :, None] * p2r[:, None, :]
    # S[a,b,c] = sum_i U[i,a,b] * P3[i,c]   (complex) — matmul contractions
    s_re = (jnp.einsum("iab,ic->abc", ur, p3r)
            - jnp.einsum("iab,ic->abc", ui, p3i))
    s_im = (jnp.einsum("iab,ic->abc", ur, p3i)
            + jnp.einsum("iab,ic->abc", ui, p3r))
    return s_re.reshape(-1), s_im.reshape(-1)


def structure_factor(pos, charge, alive, kvecs):
    """S(k) = sum_i alive_i q_i e^{i k.r_i} -> (re, im), each [Nk]."""
    q = jnp.where(alive, charge, 0.0)
    phase = pos @ kvecs.T                       # [N, Nk]
    return q @ jnp.cos(phase), q @ jnp.sin(phase)


def mol_structure_factor(pos_rows, charge_rows, row_ok, kvecs):
    """Partial S(k) from one molecule's atoms (for delta updates)."""
    q = jnp.where(row_ok, charge_rows, 0.0)
    phase = pos_rows @ kvecs.T                  # [A, Nk]
    return q @ jnp.cos(phase), q @ jnp.sin(phase)


def recip_energy_from_sk(sk_re, sk_im, box, alpha, kvecs, pair_w=2.0):
    """U_recip from a cached structure factor.  ``pair_w``: per-k pair
    weight — scalar 2 for the half-space table (each entry stands for
    +/-k), or the rect_weights vector for the cube table (0 guards the
    origin and out-of-sphere rows)."""
    v = jnp.abs(jnp.linalg.det(box))
    k2 = jnp.sum(kvecs * kvecs, axis=-1)
    k2s = jnp.where(k2 > 1e-12, k2, 1.0)
    w = pair_w * jnp.exp(-k2 / (4.0 * alpha * alpha)) / k2s
    s2 = sk_re * sk_re + sk_im * sk_im
    return KE * (2.0 * jnp.pi / v) * jnp.sum(w * s2)


def recip_energy(pos, charge, alive, box, alpha, cfg_or_kmax):
    """Full reciprocal-space energy + structure factor.  Pass the
    RunConfig for the configured representation (ewald_mxu dispatches
    to the separable matmul structure factor); an int kmax keeps the
    legacy half-space behavior."""
    if isinstance(cfg_or_kmax, int):
        kv = kvectors(box, cfg_or_kmax)
        sk_re, sk_im = structure_factor(pos, charge, alive, kv)
        return (recip_energy_from_sk(sk_re, sk_im, box, alpha, kv),
                (sk_re, sk_im))
    cfg = cfg_or_kmax
    kv, pw = ktable(box, cfg)
    if cfg.ewald_mxu:
        sk_re, sk_im = structure_factor_mxu(pos, charge, alive, box,
                                            cfg.ewald_kmax)
    else:
        sk_re, sk_im = structure_factor(pos, charge, alive, kv)
    return (recip_energy_from_sk(sk_re, sk_im, box, alpha, kv, pw),
            (sk_re, sk_im))


def self_energy(charge, alive, alpha):
    q2 = jnp.where(alive, charge * charge, 0.0)
    return -KE * alpha / jnp.sqrt(jnp.pi) * jnp.sum(q2)


def background_coefficient(alpha, volume):
    """c_bg such that the uniform-background (jellium) correction for a
    non-neutral cell is  E_bg = c_bg * Q_tot^2  (SURVEY §2 "Ewald
    electrostatics"; r2 verdict item 6).

    A net charge Q makes the bare Ewald sum gauge-dependent (the k = 0
    term diverges); adding the implicit neutralizing background
    contributes the standard  -pi Q^2 / (2 alpha^2 V)  so the total is
    alpha-independent and equals the energy of the charges in a uniform
    compensating jellium (tinfoil boundary).  Zero for a neutral cell.
    """
    return -KE * jnp.pi / (2.0 * alpha * alpha * volume)


def background_correction(charge, alive, alpha, volume):
    """E_bg = -ke pi Q^2/(2 alpha^2 V), Q = net ALIVE charge (see
    background_coefficient).  Enters the ACTIVE energy slot: under GCMC
    of a charged species Q changes per insert/delete, and the scan
    path's b_insert/b_delete carry the matching quadratic delta."""
    q_tot = jnp.sum(jnp.where(alive, charge, 0.0))
    return background_coefficient(alpha, volume) * q_tot * q_tot


def wolf_self_energy(charge, alive, alpha, rc):
    """Wolf method self/shift term:
    U_self = -ke (erfc(a rc)/(2 rc) + a/sqrt(pi)) sum q_i^2."""
    q2 = jnp.where(alive, charge * charge, 0.0)
    return -KE * (erfc(alpha * rc) / (2.0 * rc)
                  + alpha / jnp.sqrt(jnp.pi)) * jnp.sum(q2)
