"""Thole-Applequist polarizable induced-dipole model.

Rebuild of the reference's polarization stack (SURVEY.md §2 "Thole
polarization driver" / "Thole static field" / "Thole dipole tensor" /
"Thole iterative solvers", src/energy/polar.c, thole_field.c,
thole_matrix.c, thole_iterative.c [C/M]):

    mu_i = alpha_i ( E0_i + sum_{j != i} T_ij mu_j )
    U    = -(ke/2) sum_i mu_i . E0_i        (at the SCF fixed point)

- E0 is the *intermolecular* static field of the permanent charges, with
  exponential Thole damping (default width polar_damp = 2.1304 [C]).
- T is the damped dipole-dipole tensor over ALL polarizable site pairs
  (including intramolecular — that screening is the point of Thole).
- Solver: masked conjugate gradient on the SPD system
  (diag(1/alpha) - T) mu = E0.  The reference's Gauss-Seidel / SOR /
  ranked-GS orderings are inherently sequential — the wrong shape for a
  data-parallel device — but every variant converges to the same linear
  fixed point (SURVEY.md §7 "SCF solver equivalence"), so CG preserves
  parity while vectorizing.  A Jacobi mode with relaxation (polar_gamma) is provided as
  the structural analog of the reference's iteration family.
- "direct" solver builds the dense 3N'x3N' matrix and solves exactly
  (the reference's polar_iterative off / thole_bmat path) — used for
  small-system validation.

Units: charges e, positions A, alpha A^3; fields are computed WITHOUT the
Coulomb prefactor, dipoles come out in e*A, and ke enters once in the final
energy (the reference folds sqrt(ke) into its charges instead).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax.scipy.special import erf, erfc

from mpmc_tpu.constants import KE
from mpmc_tpu.ops import pbc as pbc_ops
from mpmc_tpu.ops import route
from mpmc_tpu.ops.pairs import derived_cutoff


def _damping(r, lam, kind):
    """(damp1, damp2): charge-dipole and dipole-dipole screening factors.

    - exponential: Thole's model 3 (exponential charge cloud), width lam
      in 1/A — the reference default, polar_damp 2.1304 [C];
    - linear: Thole's model 1 (linear / cone charge density, Thole 1981),
      screening lambda3 = 4u^3 - 3u^4, lambda5 = u^4 for u = r/lam < 1
      (here lam acts as the screening radius in A) — the reference's
      ``polar_damp_type linear`` [M]."""
    if kind == "none":
        one = jnp.ones_like(r)
        return one, one
    if kind == "exponential":
        x = lam * r
        e = jnp.exp(-x)
        p1 = 1.0 + x + 0.5 * x * x
        d1 = 1.0 - e * p1
        d2 = 1.0 - e * (p1 + x * x * x / 6.0)
        return d1, d2
    if kind == "linear":
        u = jnp.minimum(r / lam, 1.0)
        u3 = u * u * u
        return 4.0 * u3 - 3.0 * u3 * u, u3 * u
    raise ValueError(f"polar_damp_type {kind} not supported")


def static_field(pos, box, atom_alive, params, cfg, chunk=None):
    """Static field dispatcher (SURVEY.md §2 'Thole static field'):
    full-Ewald periodic field (polar_ewald), Wolf-damped field
    (polar_wolf), or the damped direct-cutoff field."""
    if cfg.polar_ewald:
        return static_field_ewald(pos, box, atom_alive, params, cfg,
                                  chunk=chunk)
    if cfg.polar_wolf:
        return static_field_wolf(pos, box, atom_alive, params, cfg,
                                 chunk=chunk)
    return static_field_direct(pos, box, atom_alive, params, cfg,
                               chunk=chunk)


def _field_variant_consts(box, cfg, dtype):
    """(alpha, k_rc) of the screened pairwise field kernel for the
    wolf/ewald variants ((None, None) for direct).  wolf: the shifted
    kernel's alpha (``polar_wolf_alpha`` or the derived ES alpha) and
    the kernel magnitude at the cutoff (the shift); ewald: the Ewald
    splitting alpha with zero shift (the k-space sum carries the long
    range)."""
    if not (cfg.polar_wolf or cfg.polar_ewald):
        return None, None
    rc = derived_cutoff(box, cfg)
    from mpmc_tpu.ops.pairs import derived_alpha
    if cfg.polar_ewald:          # static_field dispatch precedence
        return derived_alpha(rc, cfg), jnp.zeros((), dtype)
    if cfg.polar_wolf_alpha is not None:
        alpha = jnp.asarray(cfg.polar_wolf_alpha, dtype)
    else:
        alpha = derived_alpha(rc, cfg)
    two_a_pi = 2.0 * alpha / jnp.sqrt(jnp.pi)
    k_rc = (erfc(alpha * rc) / rc + two_a_pi
            * jnp.exp(-alpha * alpha * rc * rc)) / rc
    return alpha, k_rc


def _field_coef(r, r2s, d1, cfg, alpha=None, k_rc=None):
    """Pairwise (inter-molecular) field-kernel coefficient c(r): the
    damped field of a unit source charge at displacement dr (pointing
    toward the target) is c(r) * dr.  direct: d1/r^3
    (static_field_direct); wolf: the cutoff-shifted erfc-screened
    kernel + the Thole near-field (damped-bare) correction
    (static_field_wolf); polar_ewald: the unshifted erfc-screened
    kernel + near-field — the real-space rows of static_field_ewald
    (its recip / same-molecule terms are the caller's).  The variant is
    selected by ``alpha`` (None = direct; else screened, with ``k_rc``
    the wolf shift or 0 for ewald) so explicit callers bypass cfg."""
    if alpha is None:
        return d1 / (r2s * r)
    two_a_pi = 2.0 * alpha / jnp.sqrt(jnp.pi)
    k_r = (erfc(alpha * r) / r
           + two_a_pi * jnp.exp(-alpha * alpha * r2s)) / r
    return (k_r - k_rc) / r + (d1 - 1.0) / (r2s * r)


def _intra_coef(r, r2s, alpha):
    """erf-complement kernel of the Ewald field's same-molecule
    correction (cancels the k-space sum's intra content; applied at
    ALL separations with a minus sign): (erf(a r)/r - 2a/sqrt(pi)
    e^{-a^2 r^2}) / r^2."""
    two_a_pi = 2.0 * alpha / jnp.sqrt(jnp.pi)
    return (erf(alpha * r) / r
            - two_a_pi * jnp.exp(-alpha * alpha * r2s)) / r2s


def _recip_field_w(box, alpha, kvecs, pair_w):
    """Per-k weight of the reciprocal-space field sum:
    (4 pi / V) * pair_w * exp(-k^2/4a^2)/k^2 (pair_w = 2 for the
    half-space table, or the cube table's 0/1 sphere mask)."""
    k2 = jnp.sum(kvecs * kvecs, axis=-1)
    k2s = jnp.where(k2 > 1e-12, k2, 1.0)
    volume = jnp.abs(jnp.linalg.det(box))
    return ((4.0 * jnp.pi / volume) * pair_w
            * jnp.exp(-k2 / (4.0 * alpha * alpha)) / k2s)


def static_field_wolf(pos, box, atom_alive, params, cfg, chunk=None):
    """Wolf-damped static field (SURVEY.md §2 'Thole static field':
    polar_wolf / polar_wolf_full [M]): the erfc-screened field kernel,
    shifted so it vanishes at the cutoff (the field analog of the Wolf
    damped-shifted potential), plus the Thole near-field correction.

        E_i = sum_j q_j [ K(r) - K(rc) ] r_hat,
        K(r) = erfc(a r)/r^2 + (2a/sqrt(pi)) e^{-a^2 r^2}/r

    over intermolecular pairs within the cutoff; ``polar_wolf_alpha``
    (cfg.polar_wolf_alpha, default the ES wolf/ewald alpha) sets a."""
    N = pos.shape[0]
    B = min(chunk or cfg.pair_chunk, N)
    nb = -(-N // B)
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    alpha, k_rc = _field_variant_consts(box, cfg, pos.dtype)

    def body(_, b):
        i0 = b * B
        rows = i0 + jnp.arange(B)
        idx = jnp.clip(rows, 0, N - 1)
        rok = (rows < N) & atom_alive[idx]
        dr = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :],
                               box, box_inv)
        r2 = jnp.sum(dr * dr, -1)
        ok = (rok[:, None] & atom_alive[None, :]
              & (params.mol_id[idx][:, None] != params.mol_id[None, :])
              & (r2 < rc * rc))
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        r = jnp.sqrt(r2s)
        d1, _ = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        coef = jnp.where(ok, params.charge[None, :]
                         * _field_coef(r, r2s, d1, cfg, alpha, k_rc), 0.0)
        return None, jnp.einsum("bn,bnk->bk", coef, dr)

    _, ys = jax.lax.scan(body, None, jnp.arange(nb))
    return ys.reshape(nb * B, 3)[:N]


def cull_supported(cfg) -> bool:
    """Static gate for the cell-sorted tile-culled SCF matvec: with an
    explicit cutoff well below L/2, most (row block, column block)
    pairs of cell-sorted sites hold no pair inside rc, and the kernel
    skips them.  Requirements: an orthorhombic box (the conservative
    AABB distance bound below assumes axis-aligned min-image) and the
    CG solver (the culled matvec lives in solve_scf's sorted space).
    ``polar_cull auto`` (default) further requires an EXPLICIT cutoff:
    at the derived rc = L/2 about three quarters of the tiles stay
    visited and the dense kernel measured as fast or faster on an
    H100 at 10.8k sites (PERF.md); ``on`` forces culling there too,
    ``off`` never culls.  Whether the kernel runs at all is
    route.thole_kernel's decision."""
    if cfg.polar_cull == "off":
        return False
    if not (cfg.polarization and cfg.ortho_box
            and cfg.polar_solver == "cg"):
        return False
    return cfg.polar_cull == "on" or cfg.cutoff is not None


def cull_perm(pos, box, pol_ok, rc):
    """Cell-sort permutation for the culled matvec: x-major
    lexicographic order on rc/2 cells (consecutive sites form thin
    slabs, which cull well at the kernel's row and column block sizes);
    dead / non-polarizable sites sort last, so trailing tiles empty out
    and are skipped entirely.  Recomputed per solve (O(N log N) next to
    the O(N'^2) matvec), so moving sorbates stay spatially tight and no static
    permutation can go stale.  Returns (perm, inv)."""
    n = pos.shape[0]
    L = jnp.diagonal(box)
    cell = rc / 2.0
    frac = pos - L[None, :] * jnp.floor(pos / L[None, :])
    c = jnp.floor(frac / cell)
    ncy = jnp.ceil(L[1] / cell)
    ncz = jnp.ceil(L[2] / cell)
    key = (c[:, 0] * ncy + c[:, 1]) * ncz + c[:, 2]
    key = jnp.where(pol_ok, key, jnp.inf)
    perm = jnp.argsort(key)
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(n))
    return perm, inv


def cull_visit(pos_s, ok_s, box, rc, ti, tj, n_pad):
    """Conservative [NI,NJ] tile-visit table over CELL-SORTED sites:
    tile (I,J) is visited unless the minimum min-image distance
    between the two blocks' axis-aligned bounding boxes is >= rc (or
    either block holds no active site).  Per-dim bound: the circle
    metric's triangle inequality gives |minimage(x_i - x_j)| >=
    |minimage(c_I - c_J)| - h_I - h_J for any points inside blocks
    with centers c and half-widths h, so summing the clamped per-dim
    gaps squared under-estimates every cross-pair r^2 — tiles it culls
    contain only pairs the kernel's r2 < rc^2 mask already zeroes.

    That bound holds in exact arithmetic; the kernel's f32 min-image r2
    can come out a few ulps of the box length below the true distance.
    The cut therefore compares against rc widened by a margin of
    ``32 eps (max L + rc)``, so rounding can never cull a pair the
    kernel would count."""
    n = pos_s.shape[0]
    L = jnp.diagonal(box).astype(pos_s.dtype)
    p = pos_s - L[None, :] * jnp.floor(pos_s / L[None, :])   # wrap [0,L)
    pad = n_pad - n
    p = jnp.pad(p, ((0, pad), (0, 0)))
    ok = jnp.pad(ok_s, (0, pad))
    big = jnp.asarray(1e30, p.dtype)
    lo = jnp.where(ok[:, None], p, big)
    hi = jnp.where(ok[:, None], p, -big)

    def blocks(t):
        nb = n_pad // t
        mn = lo.reshape(nb, t, 3).min(1)
        mx = hi.reshape(nb, t, 3).max(1)
        nonempty = ok.reshape(nb, t).any(1)
        ctr = jnp.where(nonempty[:, None], 0.5 * (mn + mx), 0.0)
        hw = jnp.where(nonempty[:, None], 0.5 * (mx - mn), 0.0)
        return ctr, hw, nonempty

    ci, hwi, oki = blocks(ti)
    cj, hwj, okj = blocks(tj)
    dc = ci[:, None, :] - cj[None, :, :]
    dc = dc - L[None, None, :] * jnp.round(dc / L[None, None, :])
    gap = jnp.maximum(jnp.abs(dc) - hwi[:, None, :] - hwj[None, :, :],
                      0.0)
    mind2 = jnp.sum(gap * gap, -1)
    eps = jnp.finfo(jnp.float32).eps
    rcm = rc + 32.0 * eps * (jnp.max(L) + rc)
    visit = oki[:, None] & okj[None, :] & (mind2 < rcm * rcm)
    return visit.astype(jnp.int32)


def _sorted_sites(perm, pos, pol_ok, params):
    """(pos, pol_ok, polar, mol_id) in the culled solve's cell-sorted
    order — one place permutes every per-site array the sorted-space
    matvec reads, so none of them can be passed in the caller's
    order by mistake."""
    return pos[perm], pol_ok[perm], params.polar[perm], params.mol_id[perm]


def _rowblock_scan(body, N, B, nb, dtype, cfg):
    """Run a target-row-block pass (``body(_, b) -> (None, [B,3])``)
    either as the plain lax.scan stack, or — under
    cfg.spatial_axis (parallel/spatial.run_chunk_spatial: replicated
    state inside a shard_map) — with the row blocks round-robined
    across the mesh and the per-device partial [N,3] outputs
    reassembled by ONE psum (each row is computed by exactly one
    device, the rest contribute zeros)."""
    if cfg.spatial_axis is None:
        _, ys = jax.lax.scan(body, None, jnp.arange(nb))
        return ys.reshape(nb * B, 3)[:N]
    axis, ndev = cfg.spatial_axis
    d = jax.lax.axis_index(axis)
    nb_l = -(-nb // ndev)

    def body2(acc, bl):
        b = d + bl * ndev
        i0c = jnp.minimum(b, nb - 1) * B
        _, out = body(None, b)
        cur = jax.lax.dynamic_slice(acc, (i0c, 0), (B, 3))
        acc = jax.lax.dynamic_update_slice(
            acc, jnp.where(b < nb, out, cur), (i0c, 0))
        return acc, None

    acc0 = jnp.zeros((nb * B, 3), dtype)
    acc, _ = jax.lax.scan(body2, acc0, jnp.arange(nb_l))
    return jax.lax.psum(acc[:N], axis)


def static_field_direct(pos, box, atom_alive, params, cfg, chunk=None,
                        interpret=False):
    """Damped intermolecular electric field E0 [N,3] of permanent charges
    at every site (no ke factor; excludes same-molecule sources, applies
    the pair cutoff — SURVEY.md §2 'Thole static field', direct variant).
    ``interpret``: tests only — run the kernel in Pallas interpret mode
    (route.thole_kernel)."""
    if route.thole_kernel(cfg, interpret):
        from mpmc_tpu.ops.pallas import thole_kernel as _tk
        rc = derived_cutoff(box, cfg)
        return _tk.charge_field(pos, box, atom_alive, params.charge,
                                params.mol_id, rc,
                                jnp.asarray(cfg.polar_damp, pos.dtype),
                                cfg.polar_damp_type, ortho=cfg.ortho_box,
                                interpret=interpret).astype(pos.dtype)
    N = pos.shape[0]
    B = min(chunk or cfg.pair_chunk, N)
    nb = -(-N // B)
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)

    def body(_, b):
        i0 = b * B
        rows = i0 + jnp.arange(B)
        idx = jnp.clip(rows, 0, N - 1)
        rok = (rows < N) & atom_alive[idx]
        dr = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :],
                               box, box_inv)          # r_i - r_j (toward i)
        r2 = jnp.sum(dr * dr, -1)
        ok = (rok[:, None] & atom_alive[None, :]
              & (params.mol_id[idx][:, None] != params.mol_id[None, :])
              & (r2 < rc * rc))
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        r = jnp.sqrt(r2s)
        d1, _ = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        coef = jnp.where(ok, params.charge[None, :] * d1 / (r2s * r), 0.0)
        return None, jnp.einsum("bn,bnk->bk", coef, dr)

    return _rowblock_scan(body, N, B, nb, pos.dtype, cfg)


def field_delta_supported(cfg) -> bool:
    """Static gate for the per-move delta field (r4 verdict item 1):
    the direct damped and Wolf-shifted fields are pairwise additive in
    source charges; the full-Ewald field splits into pairwise
    real-space tiles plus a k-space term LINEAR in S(k), so it deltas
    exactly when the energy path maintains that structure factor
    (coulomb ewald — the field rides the state's S(k) table/layout).
    polar_ewald over a non-ewald energy path keeps the full rebuild."""
    if not cfg.polarization:
        return False
    if cfg.polar_ewald:
        return cfg.coulomb == "ewald"
    return True


def field_delta(pos, box, atom_alive, params, cfg, mol, e0,
                new_rows=None, insert=False, delete=False, sk=None):
    """O(A N) update of the cached static field when molecule ``mol``
    moves/appears/disappears (the per-move analog of static_field —
    the reference rebuilds the whole field each energy() call; SURVEY
    §3.2).  Thin wrapper over the fused ``move_deltas`` with the
    residual tiles disabled; see there for the tile structure and the
    wolf/ewald variant handling (``sk``)."""
    return move_deltas(pos, box, atom_alive, params, cfg, mol, e0,
                       None, None, new_rows=new_rows, insert=insert,
                       delete=delete, with_residual=False, sk=sk)[0]


def move_deltas(pos, box, atom_alive, params, cfg, mol, e0, mu, r_old,
                new_rows=None, insert=False, delete=False,
                with_residual=True, sk=None):
    """Fused field_delta + residual_delta (r4, r5-candidate #1): one
    shared pass per displacement tile.  The two functions' tiles use
    IDENTICAL min-image displacements — tile (a): the moved molecule's
    ± rows against every other site (charge sources for the field,
    dipole sources for the residual); tile (b): every other site
    against the molecule's trial rows (charge field at the rows;
    dipole field at the rows, sign-flipped) — so dr/r²/√/damping are
    computed once instead of twice, plus a tiny [A,A] self-block for
    the residual.  Per-tile summation axes match the sequential
    functions (f64 equality test ``test_move_deltas_matches_
    sequential``).  Returns (e0_new, r0_new) — r0_new is None when
    ``with_residual`` is False.

    Field variants (r4 verdict item 1): the pairwise kernel follows
    cfg (``_field_coef`` — direct / wolf / ewald-real).  polar_ewald
    additionally deltas the k-space field, which is LINEAR in S(k):
    dE_recip_j = sum_k w_k [sin(k.r_j) dSre_k - cos(k.r_j) dSim_k] k
    for every unmoved site (one [N,K] trig pass + [N,K]@[K,3]
    matmuls), while tile (b) recomputes the trial rows in full
    (recip with the post-move S(k), erfc-screened real tile, and the
    same-molecule erf-complement block of static_field_ewald).
    ``sk``: the cached pre-move (sk_re, sk_im) in the energy path's
    ewald.ktable layout (recomputed O(N K) if None).  The dipole
    (residual) tiles are field-variant independent."""
    from mpmc_tpu.state import mol_rows as _mr
    from mpmc_tpu.state import mol_rows_update as _mru
    dtype = pos.dtype
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    A = params.max_atoms_per_mol
    valid = jnp.arange(A) < params.mol_natoms[mol]
    q_rows = jnp.where(valid, _mr(params.charge, params, mol), 0.0)
    old_rows = _mr(pos, params, mol)
    mu_rows = (jnp.where(valid[:, None], _mr(mu, params, mol), 0.0)
               if with_residual else None)
    pol_site = params.polar > 0
    pol_rows = valid & (_mr(params.polar, params, mol) > 0)
    other = atom_alive & (params.mol_id != mol)
    other_pol = other & pol_site
    ew_f = cfg.polar_ewald
    alpha_f, k_rc = _field_variant_consts(box, cfg, dtype)

    if delete:
        src_pos, src_q, src_ok = old_rows, -q_rows, valid
        src_mu = -mu_rows if with_residual else None
    elif insert:
        src_pos, src_q, src_ok = new_rows, q_rows, valid
        src_mu = None            # inserted molecules carry mu = 0
    else:
        src_pos = jnp.concatenate([new_rows, old_rows])
        src_q = jnp.concatenate([q_rows, -q_rows])
        src_ok = jnp.concatenate([valid, valid])
        src_mu = (jnp.concatenate([mu_rows, -mu_rows])
                  if with_residual else None)

    # ---- tile (a): moved rows as sources vs every site --------------
    dr = pbc_ops.min_image(pos[None, :, :] - src_pos[:, None, :],
                           box, box_inv)                   # [S,N,3]
    r2 = jnp.sum(dr * dr, -1)
    in_rc = r2 < rc * rc
    r2s = jnp.where(r2 > 1e-12, r2, 1.0)
    r = jnp.sqrt(r2s)
    d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
    ok_f = src_ok[:, None] & other[None, :] & in_rc
    coef = jnp.where(ok_f, src_q[:, None]
                     * _field_coef(r, r2s, d1, cfg, alpha_f, k_rc), 0.0)
    e0_new = e0 + jnp.einsum("sn,snk->nk", coef, dr)

    if ew_f:
        # ---- k-space delta at every unmoved site (linear in S(k)) ---
        from mpmc_tpu.ops import ewald as ewald_mod
        kv, pw = ewald_mod.ktable(box, cfg)
        if sk is None:
            sk = ewald_mod.structure_factor(pos, params.charge,
                                            atom_alive, kv)
        sk_re_o, sk_im_o = sk
        d_re, d_im = ewald_mod.mol_structure_factor(src_pos, src_q,
                                                    src_ok, kv)
        w_k = _recip_field_w(box, alpha_f, kv, pw)
        phase = pos @ kv.T                                 # [N,K]
        d_rec = (jnp.sin(phase) * (w_k * d_re)[None, :]) @ kv \
            - (jnp.cos(phase) * (w_k * d_im)[None, :]) @ kv
        e0_new = e0_new + jnp.where(other[:, None], d_rec, 0.0)

    # ---- tile (b): the field/dipole field at the trial rows ---------
    if delete:
        rows_field = jnp.zeros((A, 3), dtype)
    else:
        drr = pbc_ops.min_image(new_rows[:, None, :] - pos[None, :, :],
                                box, box_inv)              # [A,N,3]
        r2b = jnp.sum(drr * drr, -1)
        in_rcb = r2b < rc * rc
        r2bs = jnp.where(r2b > 1e-12, r2b, 1.0)
        rb = jnp.sqrt(r2bs)
        d1b, d2b = _damping(rb, cfg.polar_damp, cfg.polar_damp_type)
        okb = valid[:, None] & other[None, :] & in_rcb
        cb = jnp.where(okb, params.charge[None, :]
                       * _field_coef(rb, r2bs, d1b, cfg, alpha_f, k_rc),
                       0.0)
        rows_field = jnp.einsum("an,ank->ak", cb, drr)
        if ew_f:
            # same-molecule erf-complement block (all separations) at
            # the NEW geometry: sources s -> targets t within the mol
            dra_f = pbc_ops.min_image(
                new_rows[None, :, :] - new_rows[:, None, :], box,
                box_inv)                                   # [S,T,3]
            r2i = jnp.sum(dra_f * dra_f, -1)
            diag_a = jnp.eye(A, dtype=bool)
            oki = valid[:, None] & valid[None, :] & ~diag_a
            r2is = jnp.where(r2i > 1e-12, r2i, 1.0)
            ri = jnp.sqrt(r2is)
            ci = jnp.where(oki, -q_rows[:, None]
                           * _intra_coef(ri, r2is, alpha_f), 0.0)
            rows_field = rows_field + jnp.einsum("st,stk->tk", ci,
                                                 dra_f)
            # recip field at the trial rows with the POST-move S(k)
            n_re, n_im = sk_re_o + d_re, sk_im_o + d_im
            ph_r = new_rows @ kv.T                         # [A,K]
            rows_field = rows_field \
                + (jnp.sin(ph_r) * (w_k * n_re)[None, :]) @ kv \
                - (jnp.cos(ph_r) * (w_k * n_im)[None, :]) @ kv
    cur = _mr(e0_new, params, mol)
    rows_field = jnp.where(valid[:, None], rows_field.astype(dtype),
                           cur)
    e0_out = _mru(e0_new, params, mol, rows_field)
    if not with_residual:
        return e0_out, None

    # ---- residual: r0' = r_old + (b' - b) + (T' - T) mu -------------
    rr = r_old + jnp.where(other_pol[:, None], e0_out - e0, 0.0)
    if src_mu is not None:
        okm = (src_ok[:, None] & other_pol[None, :] & in_rc
               & (r2 > 1e-12))
        inv_r3 = 1.0 / (r2s * r)
        mdotr = jnp.einsum("sk,snk->sn", src_mu, dr)
        c1 = jnp.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, 0.0)
        c2 = jnp.where(okm, d1 * inv_r3, 0.0)
        rr = rr + (jnp.einsum("sn,snk->nk", c1, dr)
                   - jnp.einsum("sn,sk->nk", c2, src_mu))

    if delete:
        rows_r = jnp.zeros((A, 3), dtype)
    else:
        # dipole field at the trial rows from every other site: tile
        # (b)'s displacements flipped toward the rows (dr_b already
        # points toward the rows: new_rows - pos)
        okbp = (valid[:, None] & other_pol[None, :] & in_rcb
                & (r2b > 1e-12))
        inv_r3b = 1.0 / (r2bs * rb)
        mu_oth = jnp.where(other_pol[:, None], mu, 0.0)
        mdotr_b = jnp.einsum("nk,ank->an", mu_oth, drr)
        c1b = jnp.where(okbp, 3.0 * d2b * mdotr_b * inv_r3b / r2bs, 0.0)
        c2b = jnp.where(okbp, d1b * inv_r3b, 0.0)
        e_rows = (jnp.einsum("an,ank->ak", c1b, drr)
                  - jnp.einsum("an,nk->ak", c2b, mu_oth))
        # the [A,A] self-block: the molecule's own (trial) rows as
        # dipole sources at each other's positions
        dra = pbc_ops.min_image(
            new_rows[None, :, :] - new_rows[:, None, :], box, box_inv)
        r2a = jnp.sum(dra * dra, -1)
        diag = jnp.eye(A, dtype=bool)
        oka = (pol_rows[:, None] & valid[None, :] & ~diag
               & (r2a < rc * rc) & (r2a > 1e-12))
        r2as = jnp.where(r2a > 1e-12, r2a, 1.0)
        ra = jnp.sqrt(r2as)
        d1a, d2a = _damping(ra, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3a = 1.0 / (r2as * ra)
        mdotr_a = jnp.einsum("sk,sak->sa", mu_rows, dra)
        c1a = jnp.where(oka, 3.0 * d2a * mdotr_a * inv_r3a / r2as, 0.0)
        c2a = jnp.where(oka, d1a * inv_r3a, 0.0)
        e_rows = e_rows + (jnp.einsum("sa,sak->ak", c1a, dra)
                           - jnp.einsum("sa,sk->ak", c2a, mu_rows))
        inv_a = jnp.where(
            pol_rows,
            1.0 / jnp.maximum(_mr(params.polar, params, mol), 1e-30),
            0.0)
        rows_r = (jnp.where(valid[:, None],
                            _mr(e0_out, params, mol), 0.0)
                  - inv_a[:, None] * mu_rows + e_rows)
        rows_r = jnp.where(pol_rows[:, None], rows_r, 0.0)
    cur_r = _mr(rr, params, mol)
    rows_r = jnp.where(valid[:, None], rows_r.astype(dtype), cur_r)
    return e0_out, _mru(rr, params, mol, rows_r)


def residual_supported(cfg) -> bool:
    """Static gate for the O(A N) analytic initial CG residual: needs the
    delta static field (any field_delta_supported variant — the dipole
    tiles are field-variant independent) and the CG solver (the residual
    is threaded through the CG recurrence and carried in SimState)."""
    return field_delta_supported(cfg) and cfg.polar_solver == "cg"


def residual_delta(pos, box, atom_alive, params, cfg, mol, mu, r_old,
                   e0_old, e0_new, new_rows=None, insert=False,
                   delete=False):
    """O(A N) initial CG residual for the candidate system,

        r0' = b' - A' mu,

    given the previous solve's final residual r_old = b - A mu.  One move
    changes A = diag(1/alpha) - T only in the moved molecule's rows and
    columns, and b only through the already-computed static-field delta,
    so (VERDICT r1 item 1c)

        r0' = r_old + (b' - b) + (T' - T) mu

    needs two O(A N) dipole-field tiles instead of the full O(N^2)
    matvec the warm-started CG would otherwise spend on ``b - A x0``:
    (a) the moved dipoles as sources (+mu at the trial rows, -mu at the
    current rows) against every other polarizable site, and (b) a full
    recompute of the moved rows' own residual entries (their T row and
    diagonal change wholesale).  Exact in exact arithmetic; the
    per-corrtime ``initialize`` refresh re-grounds f32 drift exactly as
    it does for e0 and S(k).  ``atom_alive`` is the PRE-move mask."""
    from mpmc_tpu.state import mol_rows as _mr
    from mpmc_tpu.state import mol_rows_update as _mru
    dtype = pos.dtype
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    A = params.max_atoms_per_mol
    valid = jnp.arange(A) < params.mol_natoms[mol]
    pol_site = params.polar > 0
    pol_rows = valid & (_mr(params.polar, params, mol) > 0)
    old_rows = _mr(pos, params, mol)
    mu_rows = jnp.where(valid[:, None], _mr(mu, params, mol), 0.0)

    other_pol = (atom_alive & (params.mol_id != mol)
                 & pol_site)[..., None]

    # (b' - b) for unmoved sites
    r = r_old + jnp.where(other_pol, e0_new - e0_old, 0.0)

    def dip_field(tgt_pos, src_pos, src_mu, ok):
        """Damped dipole field of (src_pos, src_mu) at tgt_pos (mask ok
        [S,T] applied) — mirrors dipole_matvec's kernel exactly."""
        dr = pbc_ops.min_image(tgt_pos[None, :, :] - src_pos[:, None, :],
                               box, box_inv)           # [S,T,3] toward tgt
        r2 = jnp.sum(dr * dr, -1)
        okm = ok & (r2 < rc * rc) & (r2 > 1e-12)
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        rr = jnp.sqrt(r2s)
        d1, d2 = _damping(rr, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3 = 1.0 / (r2s * rr)
        mdotr = jnp.einsum("sk,stk->st", src_mu, dr)
        c1 = jnp.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, 0.0)
        c2 = jnp.where(okm, d1 * inv_r3, 0.0)
        return (jnp.einsum("st,stk->tk", c1, dr)
                - jnp.einsum("st,sk->tk", c2, src_mu))

    # (a) moved dipoles as sources against every other polarizable site.
    # Inserted molecules carry mu = 0, so their tensor columns are inert.
    if delete:
        src_pos, src_mu, src_ok = old_rows, -mu_rows, valid
    elif insert:
        src_pos = None
    else:
        src_pos = jnp.concatenate([new_rows, old_rows])
        src_mu = jnp.concatenate([mu_rows, -mu_rows])
        src_ok = jnp.concatenate([valid, valid])
    if src_pos is not None:
        ok_a = src_ok[:, None] & other_pol[None, :, 0]
        r = r + dip_field(pos, src_pos, src_mu, ok_a)

    # (b) the moved rows' own residual entries, recomputed in full:
    #     r_row = E0'_row - mu_row / alpha_row + (T' mu)_row
    if delete:
        rows_r = jnp.zeros((A, 3), dtype)
    else:
        tgt = new_rows
        src2_pos = jnp.concatenate([pos, tgt])
        src2_mu = jnp.concatenate([jnp.where(other_pol, mu, 0.0), mu_rows])
        src2_ok = jnp.concatenate([other_pol[:, 0], pol_rows])
        # intra block: exclude self-pairs (source a == target a)
        self_m = jnp.concatenate(
            [jnp.zeros((pos.shape[0], A), bool), jnp.eye(A, dtype=bool)])
        ok_b = src2_ok[:, None] & valid[None, :] & ~self_m
        e_rows = dip_field(tgt, src2_pos, src2_mu, ok_b)
        inv_a = jnp.where(
            pol_rows,
            1.0 / jnp.maximum(_mr(params.polar, params, mol), 1e-30),
            0.0)
        rows_r = (jnp.where(valid[:, None],
                            _mr(e0_new, params, mol), 0.0)
                  - inv_a[:, None] * mu_rows + e_rows)
        rows_r = jnp.where(pol_rows[:, None], rows_r, 0.0)
    # slice read-modify-write: rows beyond natoms belong to the NEXT
    # molecule and keep their (tile-(a)-updated) residual values
    cur = _mr(r, params, mol)
    rows_r = jnp.where(valid[:, None], rows_r.astype(dtype), cur)
    return _mru(r, params, mol, rows_r)


def static_field_ewald(pos, box, atom_alive, params, cfg, chunk=None):
    """Full-Ewald periodic static field (SURVEY.md §2 'Thole static
    field': ``polar_ewald`` / ewald_estatic [M names]).

    Decomposition (all without the ke prefactor):
      E_i = E_recip_i                    (k-space field of ALL charges)
          + E_real_i                     (erfc-screened short range, inter)
          - E_intra_i                    (erf-complement: cancels the
                                          same-molecule part of k-space)
          + E_damp_i                     (Thole near-field correction:
                                          damped minus bare 1/r^2 kernel,
                                          inter pairs within cutoff)
    Tinfoil (conducting) boundary convention, as standard for Ewald: in a
    large box this equals the direct damped field plus the uniform surface
    term +4 pi P/(3V); in a periodic cell it adds the image contributions
    the direct variant truncates.
    """
    from mpmc_tpu.ops import ewald
    N = pos.shape[0]
    B = min(chunk or cfg.pair_chunk, N)
    nb = -(-N // B)
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    from mpmc_tpu.ops.pairs import derived_alpha
    alpha = derived_alpha(rc, cfg)
    k_rc = jnp.zeros((), pos.dtype)     # unshifted: k-space has the tail
    q = jnp.where(atom_alive, params.charge, 0.0)

    # --- reciprocal-space field (the energy path's k-table/layout; the
    # association order matches move_deltas' delta tiles exactly) ----------
    kv, pw = ewald.ktable(box, cfg)                     # [K,3]
    sk_re, sk_im = ewald.structure_factor(pos, params.charge, atom_alive,
                                          kv)
    w = _recip_field_w(box, alpha, kv, pw)              # [K]
    phase = pos @ kv.T                                   # [N,K]
    e_recip = (jnp.sin(phase) * (w * sk_re)[None, :]) @ kv \
        - (jnp.cos(phase) * (w * sk_im)[None, :]) @ kv   # [N,3]

    # --- real-space pieces (chunked pass) -----------------------------------

    def body(_, b):
        i0 = b * B
        rows = i0 + jnp.arange(B)
        idx = jnp.clip(rows, 0, N - 1)
        rok = (rows < N) & atom_alive[idx]
        dr = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :],
                               box, box_inv)
        r2 = jnp.sum(dr * dr, -1)
        same = params.mol_id[idx][:, None] == params.mol_id[None, :]
        diag = rows[:, None] == jnp.arange(N)[None, :]
        base_ok = rok[:, None] & atom_alive[None, :] & ~diag
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        r = jnp.sqrt(r2s)
        d1, _ = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        # erfc-screened kernel + Thole near-field (inter, within cutoff)
        m_real = base_ok & ~same & (r2 < rc * rc)
        # erf-complement kernel (intra, all separations): cancels the
        # same-molecule content of the k-space sum
        m_intra = base_ok & same
        coef = (jnp.where(m_real,
                          _field_coef(r, r2s, d1, cfg, alpha, k_rc), 0.0)
                - jnp.where(m_intra, _intra_coef(r, r2s, alpha), 0.0)
                ) * q[None, :]
        return None, jnp.einsum("bn,bnk->bk", coef, dr)

    _, ys = jax.lax.scan(body, None, jnp.arange(nb))
    e_real = ys.reshape(nb * B, 3)[:N]
    e = e_recip + e_real
    return jnp.where(atom_alive[:, None], e, 0.0)


def dipole_matvec(pos, box, atom_alive, params, cfg, mu, chunk=None,
                  interpret=False):
    """(T mu)_i: damped dipole-field of all other sites' dipoles at site i.

    E_i = sum_j [ 3 d2 (r.mu_j) r / r^5 - d1 mu_j / r^3 ],  r = r_i - r_j.
    Includes intramolecular pairs; applies the cutoff.  Runs the
    Triton kernel where route.thole_kernel says so (``interpret``:
    tests only).
    """
    if route.thole_kernel(cfg, interpret):
        from mpmc_tpu.ops.pallas import thole_kernel as _tk
        pol_ok = atom_alive & (params.polar > 0)
        rc = derived_cutoff(box, cfg)
        return _tk.dipole_field(pos, box, pol_ok,
                                jnp.where(pol_ok[:, None], mu, 0.0),
                                params.mol_id, rc,
                                jnp.asarray(cfg.polar_damp, pos.dtype),
                                cfg.polar_damp_type, ortho=cfg.ortho_box,
                                interpret=interpret).astype(pos.dtype)
    N = pos.shape[0]
    B = min(chunk or cfg.pair_chunk, N)
    nb = -(-N // B)
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    pol_ok = atom_alive & (params.polar > 0)

    def body(_, b):
        i0 = b * B
        rows = i0 + jnp.arange(B)
        idx = jnp.clip(rows, 0, N - 1)
        rok = (rows < N) & pol_ok[idx]
        dr = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :],
                               box, box_inv)
        r2 = jnp.sum(dr * dr, -1)
        diag = rows[:, None] == jnp.arange(N)[None, :]
        ok = rok[:, None] & pol_ok[None, :] & ~diag & (r2 < rc * rc)
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        r = jnp.sqrt(r2s)
        d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3 = 1.0 / (r2s * r)
        mdotr = jnp.einsum("nk,bnk->bn", mu, dr)
        t1 = (3.0 * d2 * mdotr * inv_r3 / r2s)[..., None] * dr
        t2 = (d1 * inv_r3)[..., None] * mu[None, :, :]
        contrib = jnp.where(ok[..., None], t1 - t2, 0.0)
        return None, jnp.sum(contrib, axis=1)

    return _rowblock_scan(body, N, B, nb, pos.dtype, cfg)


def solve_scf(pos, box, atom_alive, params, cfg, e0, mu0=None, r0=None,
              interpret=False):
    """Solve (diag(1/alpha) - T) mu = E0 by masked CG (or Jacobi/direct).

    Returns (mu [N,3], n_iter, r [N,3] or None).  Dead / non-polarizable
    sites are pinned to zero.  Convergence: ||residual||_rms <=
    polar_precision (e*A units per site), or polar_max_iter iterations.

    ``r0``: precomputed initial residual b - A mu0 (see residual_delta) —
    skips the warm start's full matvec.  ``r`` is CG's final recurrence
    residual (None for the jacobi/direct solvers), fed back as the next
    move's r_old.  ``interpret``: tests only — run the kernel (and the
    culled CG where cull_supported) in Pallas interpret mode.
    """
    pol_ok = atom_alive & (params.polar > 0)
    cull = route.thole_kernel(cfg, interpret) and cull_supported(cfg)
    if cull:
        # tile-culled CG: cell-sort the sites per solve, run the whole
        # CG recurrence in sorted space with the conservative
        # tile-visit table (cull_visit), un-permute at the end.  The
        # culled matvec equals the dense one bit-for-bit (skipped
        # tiles hold only cutoff-masked zero pairs); only the CG
        # reduction order changes (ulp-level reassociation).  Every
        # per-site array the kernel reads goes through the same
        # permutation (_sorted_sites).
        from mpmc_tpu.ops.pallas import thole_kernel as _tk
        rc_c = derived_cutoff(box, cfg)
        perm, invp = cull_perm(pos, box, pol_ok, rc_c)
        pos, pol_ok, polar_vec, mol_s = _sorted_sites(perm, pos, pol_ok,
                                                      params)
        e0 = e0[perm]
        mu0 = mu0[perm] if mu0 is not None else None
        r0 = r0[perm] if r0 is not None else None
        n_pad, _, _ = _tk.grid_shape(pos.shape[0])
        visit = cull_visit(pos, pol_ok, box, rc_c, _tk.BI, _tk.BJ,
                           n_pad)
    else:
        polar_vec = params.polar
    mask = pol_ok[:, None]
    inv_a = jnp.where(pol_ok, 1.0 / jnp.maximum(polar_vec, 1e-30),
                      0.0)[:, None]
    b = jnp.where(mask, e0, 0.0)
    nsites = jnp.maximum(jnp.sum(pol_ok), 1)
    tol2 = (cfg.polar_precision ** 2) * nsites * 3

    def amul(x):
        x = jnp.where(mask, x, 0.0)
        if cull:
            t = _tk.dipole_field(
                pos, box, pol_ok, x, mol_s, rc_c,
                jnp.asarray(cfg.polar_damp, pos.dtype),
                cfg.polar_damp_type, ortho=cfg.ortho_box, visit=visit,
                interpret=interpret).astype(pos.dtype)
        else:
            t = dipole_matvec(pos, box, atom_alive, params, cfg, x,
                              interpret=interpret)
        return jnp.where(mask, inv_a * x - t, 0.0)

    if cfg.polar_solver == "direct":
        mu_d, it_d = _solve_direct(pos, box, atom_alive, params, cfg, b,
                                   pol_ok)
        return mu_d, it_d, None

    if cfg.polar_solver == "jacobi":
        # mu <- (1-g) mu + g alpha (E0 + T mu); reference's plain iteration
        # with relaxation polar_gamma (SURVEY.md §2 'Thole iterative
        # solvers': SOR/ESOR family).
        g = cfg.polar_gamma
        alpha_site = jnp.where(mask, params.polar[:, None], 0.0)

        def jbody(i, mu):
            t = dipole_matvec(pos, box, atom_alive, params, cfg, mu,
                              interpret=interpret)
            return jnp.where(mask, (1 - g) * mu + g * alpha_site * (b + t),
                             0.0)

        mu = mu0 if mu0 is not None else jnp.zeros_like(e0)
        mu = jax.lax.fori_loop(0, cfg.polar_max_iter, jbody, mu)
        return mu, jnp.asarray(cfg.polar_max_iter), None

    # --- preconditioned conjugate gradient (default) ------------------------
    # Jacobi preconditioner M = diag(A) = diag(1/alpha) exactly (T has
    # zero self-blocks — dipole_tensor), i.e. z = alpha*r elementwise.
    # Same fixed point and the SAME stopping criterion (unpreconditioned
    # ||r||_rms <= polar_precision) as plain CG; it only re-scales the
    # Krylov directions, which cuts iterations when site
    # polarizabilities span a wide range (MOF frameworks).  One extra
    # [N,3] multiply + reduction per iteration — noise next to the
    # O(N'^2) matvec.
    #
    # cfg.polar_precision_mode == "dipole": the REFERENCE's stopping
    # rule instead (SURVEY §2 "Thole iterative solvers": converges on
    # the per-iteration RMS dipole CHANGE, polar_precision in DEBYE
    # [L unit]).  Our residual rule is the tighter [M] deviation and
    # stays the default; this mode reproduces the reference's
    # convergence semantics (typically fewer iterations at the same
    # nominal precision value).  The change tracked is CG's own update
    # ||alpha p||_rms — the exact analog of the reference's
    # per-sweep delta.
    dip_mode = cfg.polar_precision_mode == "dipole"
    if dip_mode:
        from mpmc_tpu.constants import DEBYE_PER_EA
        tol2 = ((cfg.polar_precision / DEBYE_PER_EA) ** 2) * nsites * 3
    alpha_site = jnp.where(mask, polar_vec[:, None], 0.0)
    x = jnp.where(mask, mu0, 0.0) if mu0 is not None else jnp.zeros_like(e0)
    r = jnp.where(mask, r0, 0.0) if r0 is not None else b - amul(x)
    z = alpha_site * r
    p = z
    rs = jnp.sum(r * r)
    rz = jnp.sum(r * z)
    # dipole mode runs DO-WHILE (>= 1 iteration, like the reference's
    # per-sweep change rule, which always applies one sweep before
    # testing): gating the warm start on the pending update ||z||^2
    # let a solve do ZERO iterations whenever the previous move left a
    # small preconditioned residual, so the carried dipoles lagged the
    # moving fixed point and U_pol drifted ~1.4 K over 192 unrefreshed
    # bench-size steps (r5 in-situ gate, BENCH_FULL
    # u_pol_drift_K_measured) — vs a 0.0002 K floor for the residual
    # rule measured identically.  One forced true-operator application
    # per solve restores tracking; the residual rule keeps its
    # converged-warm-start skip.
    ds0 = jnp.asarray(jnp.inf, rs.dtype) if dip_mode else rs

    def cond(carry):
        x, r, p, rs, rz, ds, it = carry
        gate = ds if dip_mode else rs
        return (it < cfg.polar_max_iter) & (gate > tol2)

    def step(carry):
        x, r, p, rs, rz, ds, it = carry
        ap = amul(p)
        denom = jnp.sum(p * ap)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-300, denom, 1e-300)
        dx = alpha * p
        x = x + dx
        r = r - alpha * ap
        z = alpha_site * r
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-300, rz, 1e-300)
        p = z + beta * p
        ds_new = jnp.sum(dx * dx) if dip_mode else rs
        return x, r, p, jnp.sum(r * r), rz_new, ds_new, it + 1

    x, r, p, rs, rz, ds, it = jax.lax.while_loop(
        cond, step, (x, r, p, rs, rz, ds0, jnp.zeros((), jnp.int32)))
    x = jnp.where(mask, x, 0.0)
    r = jnp.where(mask, r, 0.0)
    if cull:
        x, r = x[invp], r[invp]      # back to the caller's site order
    return x, it, r


def dipole_tensor(pos, box, site_ok, cfg):
    """Damped dipole-dipole interaction tensor T [N,N,3,3] over the given
    sites (pair cutoff + Thole damping; zero blocks where either site is
    masked or on the diagonal).  Shared by the direct polarization solve
    and the coupled-dipole vdW eigenproblem (the reference shares its
    A-matrix machinery the same way, SURVEY.md §2 "Coupled-dipole vdW")."""
    N = pos.shape[0]
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    dr = pbc_ops.min_image(pos[:, None, :] - pos[None, :, :], box, box_inv)
    r2 = jnp.sum(dr * dr, -1)
    diag = jnp.eye(N, dtype=bool)
    ok = site_ok[:, None] & site_ok[None, :] & ~diag & (r2 < rc * rc)
    r2s = jnp.where(r2 > 1e-12, r2, 1.0)
    r = jnp.sqrt(r2s)
    d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
    inv_r3 = 1.0 / (r2s * r)
    eye3 = jnp.eye(3, dtype=pos.dtype)
    t = (3.0 * d2[..., None, None] * dr[..., :, None] * dr[..., None, :]
         * (inv_r3 / r2s)[..., None, None]
         - d1[..., None, None] * inv_r3[..., None, None] * eye3)
    return jnp.where(ok[..., None, None], t, 0.0)


def _solve_direct(pos, box, atom_alive, params, cfg, b, pol_ok):
    """Dense exact solve — the reference's matrix-inversion path
    (src/energy/thole_matrix.c thole_bmat [M]).  O((3N)^3); small systems."""
    N = pos.shape[0]
    eye3 = jnp.eye(3, dtype=pos.dtype)
    t = dipole_tensor(pos, box, pol_ok, cfg)
    # A[(i a),(j b)] = delta_ij delta_ab / alpha_i - T[i,j,a,b]
    inv_a = jnp.where(pol_ok, 1.0 / jnp.maximum(params.polar, 1e-30), 1.0)
    a_mat = (jnp.kron(jnp.diag(inv_a), eye3)
             - t.transpose(0, 2, 1, 3).reshape(3 * N, 3 * N))
    mu = jnp.linalg.solve(a_mat, b.reshape(3 * N)).reshape(N, 3)
    return jnp.where(pol_ok[:, None], mu, 0.0), jnp.asarray(0)


def polar_energy(mu, e0):
    """U_pol = -(ke/2) sum mu . E0   [K]."""
    return -0.5 * KE * jnp.sum(mu * e0)


def zodid_energy(e0, atom_alive, params):
    """Zeroth-iteration ("zodid") polarization energy: mu = alpha E0
    with no dipole-dipole coupling, U* = -(ke/2) sum alpha |E0|^2 [K].

    The reference exposes this as its polar_zodid diagnostic level
    (SURVEY.md §2.9 "Polarization"); here it is the surrogate target of
    the delayed-acceptance polar MC (RunConfig.polar_delayed) — O(N)
    given the cached static field, vs the O(N'^2)-matvec SCF solve."""
    pol_ok = atom_alive & (params.polar > 0)
    a = jnp.where(pol_ok, params.polar, 0.0)
    return -0.5 * KE * jnp.sum(a * jnp.sum(e0 * e0, axis=1))


def polarizability_tensor(pos, box, atom_alive, params, cfg):
    """System polarizability tensor alpha[a,b] [A^3]: apply a unit uniform
    field along each axis, solve the coupled-dipole SCF, and sum the
    induced dipoles — the reference's ``polarizability_tensor`` output
    (SURVEY.md §2 "Thole direct inversion" / §2.9 "Polarization")."""
    pol_ok = atom_alive & (params.polar > 0)
    cols = []
    for b in range(3):
        e0 = jnp.zeros((pos.shape[0], 3), pos.dtype).at[:, b].set(1.0)
        e0 = jnp.where(pol_ok[:, None], e0, 0.0)
        mu, _, _ = solve_scf(pos, box, atom_alive, params, cfg, e0)
        cols.append(jnp.sum(jnp.where(pol_ok[:, None], mu, 0.0), axis=0))
    return jnp.stack(cols, axis=1)
