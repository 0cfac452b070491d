"""Masked O(N^2) pair-interaction passes.

Rebuild of the reference's pair machinery (SURVEY.md §2 "Pair builder",
src/energy/pairs.c [C] + the RD/ES real-space loops): instead of a linked
pair list with per-pair caches, we run *chunked row-block passes* over the
padded atom array — each block computes a [B, N] tile of minimum-image
displacements, applies masks (alive, triangular i<j, intra-molecular
exclusion, cutoff), and reduces the enabled energy terms.  The same
per-tile math is reused three ways:

- ``pair_pass``      : full-system energy (scan over all row blocks);
- ``mol_pair_pass``  : one molecule's rows vs everything (the delta-energy
                       path — functional analog of the reference's
                       ``recalculate_energy`` pair flags).

Terms fused in one pass (they share dr/r): repulsion–dispersion (LJ/SG/...,
with optional Feynman-Hibbs), Ewald real-space erfc, intramolecular Ewald
exclusion correction (-erf), and the position-independent LJ tail
coefficient (summed here because it shares the masks).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import erf, erfc

from mpmc_tpu.constants import KE
from mpmc_tpu.ops import lj as lj_ops
from mpmc_tpu.ops import pbc as pbc_ops
from mpmc_tpu.ops import potentials


def derived_cutoff(box, cfg):
    """Static cutoff if configured, else half min perpendicular width."""
    if cfg.cutoff is not None:
        return jnp.asarray(cfg.cutoff, box.dtype)
    return pbc_ops.default_cutoff(box)


def derived_alpha(cutoff, cfg):
    """Damping/splitting parameter for the configured electrostatics.

    Ewald: reference default ~3.5/cutoff (SURVEY.md §2 "Ewald
    electrostatics" [M value]).  Wolf: a much softer default 2/cutoff —
    heavy damping loses the long-range physics the Wolf shift is meant to
    capture (``wolf_alpha`` overrides, SURVEY.md §2.9 "ES").
    """
    if cfg.coulomb == "wolf":
        if cfg.wolf_alpha is not None:
            return jnp.asarray(cfg.wolf_alpha, jnp.result_type(cutoff))
        return 2.0 / cutoff
    if cfg.ewald_alpha is not None:
        return jnp.asarray(cfg.ewald_alpha, jnp.result_type(cutoff))
    return 3.5 / cutoff


@dataclasses.dataclass(frozen=True)
class PairTerms:
    """Partial sums from a pair pass (pytree).  ``min_r2`` tracks the
    closest active inter-molecular approach — the rebuild of the
    reference's ``cavity_autoreject_absolute`` overlap check
    (SURVEY.md §2 "Boltzmann/acceptance")."""
    rd: jax.Array
    es_real: jax.Array
    es_excl: jax.Array
    lrc_coeff: jax.Array   # sum of tail coefficients; U_lrc = lrc_coeff / V
    min_r2: jax.Array

    def combine(self, o):
        return PairTerms(self.rd + o.rd, self.es_real + o.es_real,
                         self.es_excl + o.es_excl,
                         self.lrc_coeff + o.lrc_coeff,
                         jnp.minimum(self.min_r2, o.min_r2))

    @classmethod
    def zero(cls, dtype):
        z = jnp.zeros((), dtype)
        return cls(z, z, z, z, jnp.asarray(jnp.inf, dtype))


jax.tree_util.register_dataclass(PairTerms)


def mol_row_params(params, mol):
    """Per-row parameter vectors of one molecule via contiguous-slot
    slices (state.mol_rows) — the gather-free row side of the per-move
    delta tile (batched row gathers are slow and a compile hazard on
    this backend, CLAUDE.md)."""
    from mpmc_tpu.state import mol_rows as _mr
    a = params.max_atoms_per_mol
    return {
        "charge": _mr(params.charge, params, mol),
        "eps": _mr(params.eps, params, mol),
        "sig": _mr(params.sig, params, mol),
        "c6": _mr(params.c6, params, mol),
        "c8": _mr(params.c8, params, mol),
        "c10": _mr(params.c10, params, mol),
        "gwp_alpha": _mr(params.gwp_alpha, params, mol),
        "polar": _mr(params.polar, params, mol),
        "omega": _mr(params.omega, params, mol),
        "mol_mass": jnp.broadcast_to(params.mol_mass[mol], (a,)),
    }


def rd_tile_energy(r, r2s, idx_i, params, cfg, temperature, rc=None,
                   row=None):
    """Per-pair RD energies for a [B, N] tile of rows ``idx_i`` against all
    columns (no masks applied).  Returns (rd_u, tail_coeff) — either may be
    None when disabled.  Shared by the cutoff pair pass and the
    periodic-image crystal sum (ops/crystal.py).

    ``row``: precomputed per-row parameter dict (mol_row_params) — the
    molecule delta pass supplies it so no ``x[idx_i]`` gathers lower."""
    rg = ((lambda name: row[name]) if row is not None
          else (lambda name: getattr(params, name)[idx_i]))
    rd_u = None
    tc = None
    if cfg.cdvdw_repulsion != "none":
        # repulsion-only RD paired with the many-body dispersion
        # eigensolve (ops/vdw.py); replaces the LJ form wholesale —
        # see potentials.cdvdw_repulsion_energy for provenance.
        re_ = lambda name: rg(name)[:, None]
        ce_ = lambda x: x[None, :]
        args = (re_("eps"), ce_(params.eps), re_("sig"),
                ce_(params.sig), re_("polar"), ce_(params.polar),
                re_("omega"), ce_(params.omega))
        rd_u = potentials.cdvdw_repulsion_energy(r, *args, cfg)
        if cfg.rd_lrc and rc is not None:
            tc = potentials.cdvdw_repulsion_tail_coefficient(
                args[2], args[3], args[4], args[5], args[6], args[7],
                rc, cfg)
            tc = jnp.broadcast_to(tc, r2s.shape)
    elif cfg.rd_potential == "lj":
        eps, sig = lj_ops.mix(rg("eps")[:, None],
                              params.eps[None, :],
                              rg("sig")[:, None],
                              params.sig[None, :], cfg.mixing_rule)
        rd_u = lj_ops.energy(r2s, eps, sig)
        if cfg.feynman_hibbs or cfg.feynman_kleinert:
            mm_i = (row["mol_mass"] if row is not None
                    else params.mol_mass[params.mol_id[idx_i]])
            mm_j = params.mol_mass[params.mol_id]
            red = (mm_i[:, None] * mm_j[None, :]
                   / jnp.maximum(mm_i[:, None] + mm_j[None, :], 1e-30))
            if cfg.feynman_kleinert:
                rd_u = rd_u + lj_ops.feynman_kleinert(r, eps, sig, red,
                                                      temperature)
            else:
                rd_u = rd_u + lj_ops.feynman_hibbs(
                    r, eps, sig, red, temperature, cfg.feynman_hibbs_order)
        if cfg.rd_lrc and rc is not None:
            tc = lj_ops.tail_coefficient(eps, sig, rc)
            tc = jnp.broadcast_to(tc, r2s.shape)
    elif cfg.rd_potential in ("sg", "dreiding", "b14_7", "disp_expansion"):
        col = lambda x: x[None, :]
        rd_u = potentials.rd_pair_energy_generic(
            r, rg("eps")[:, None], col(params.eps), rg("sig")[:, None],
            col(params.sig), rg("c6")[:, None], col(params.c6),
            rg("c8")[:, None], col(params.c8), rg("c10")[:, None],
            col(params.c10), cfg)
        if (cfg.rd_potential == "disp_expansion" and cfg.rd_lrc
                and rc is not None):
            c6 = jnp.sqrt(jnp.maximum(
                rg("c6")[:, None] * params.c6[None, :], 0.0))
            c8 = jnp.sqrt(jnp.maximum(
                rg("c8")[:, None] * params.c8[None, :], 0.0))
            c10 = jnp.sqrt(jnp.maximum(
                rg("c10")[:, None] * params.c10[None, :], 0.0))
            tc = potentials.disp_tail_coefficient(c6, c8, c10, rc)
    elif cfg.rd_potential == "none":
        pass
    else:
        raise ValueError(f"unknown rd_potential {cfg.rd_potential}")
    return rd_u, tc


def _tile_values(r2, idx_i, params, cfg, rc, alpha, temperature,
                 row=None):
    """Per-pair energy values for a [B, N] tile of rows ``idx_i`` against
    all columns — no masks applied.  Returns (rd_u, es_u, ex_u, tc):

    - rd_u: repulsion-dispersion values (None if disabled);
    - es_u: real-space electrostatics under the cutoff;
    - ex_u: Ewald intramolecular exclusion correction (-erf term);
    - tc:   distance-independent long-range tail coefficients.

    ``row``: mol_row_params dict — gather-free row parameters for the
    molecule delta pass.
    """
    rg = ((lambda name: row[name]) if row is not None
          else (lambda name: getattr(params, name)[idx_i]))
    r2s = jnp.where(r2 > 1e-12, r2, 1.0)                  # guard the diagonal
    r = jnp.sqrt(r2s)
    qi = rg("charge")
    qq = qi[:, None] * params.charge[None, :]

    # --- repulsion–dispersion ------------------------------------------------
    # (tail: ordered pairs i!=j (inter) count once per direction in the
    # full triangular pass -> handled by caller symmetrization.)
    rd_u, tc = rd_tile_energy(r, r2s, idx_i, params, cfg, temperature, rc,
                              row=row)

    # --- electrostatics (real space) ----------------------------------------
    es_u = None
    ex_u = None
    if cfg.coulomb == "ewald":
        es_u = KE * qq * erfc(alpha * r) / r
        # recip space includes intramolecular pairs: subtract erf part
        # (SURVEY.md §2 "Ewald electrostatics": intramolecular exclusion
        # correction via erf).  Applied at any separation (no cutoff).
        ex_u = -KE * qq * erf(alpha * r) / r
    elif cfg.coulomb == "wolf":
        # Wolf damped, shifted pair part; self/shift terms added by caller.
        es_u = KE * qq * (erfc(alpha * r) / r - erfc(alpha * rc) / rc)
    elif cfg.coulomb == "cutoff":
        es_u = KE * qq / r
    elif cfg.coulomb == "gwp":
        # Gaussian-wave-packet smeared charges (SURVEY.md §2 "GWP
        # coulomb", src/energy/coulombic_gwp.c [M]): two normalized
        # Gaussians of widths s_i interact as erf(r/sqrt(2(s_i^2+s_j^2)))/r
        # (point charges where both widths are 0).
        s2 = (rg("gwp_alpha")[:, None] ** 2
              + params.gwp_alpha[None, :] ** 2)
        smear = jnp.where(s2 > 1e-12,
                          erf(r / jnp.sqrt(2.0 * jnp.maximum(s2, 1e-12))),
                          1.0)
        es_u = KE * qq * smear / r
    elif cfg.coulomb == "none":
        pass
    else:
        raise ValueError(f"unknown coulomb mode {cfg.coulomb}")
    return rd_u, es_u, ex_u, tc


def _block_terms(pos_i, idx_i, row_valid, pos, alive, params, cfg,
                 box, box_inv, rc, alpha, temperature, triangular,
                 split_frozen=False, row=None, mol_of_rows=None,
                 tri_extra_cols=0):
    """Energy contributions of one row block [B] against all columns [N].

    Returns PairTerms of scalars — or, with ``split_frozen``, a tuple
    (active, frozen_frozen) where the second holds only pairs internal to
    the frozen framework (the reference's forever-cached frozen pairs,
    SURVEY.md §1 "delta energy").  Splitting keeps the huge constant
    framework terms out of the MC delta accumulators, which is what makes
    f32 accumulation viable (SURVEY.md §7 "Hard parts": f64 vs f32).

    ``triangular``: only count j > i (full pass); otherwise count every
    (row, col) pair once (molecule pass, where the caller guarantees rows
    and columns are disjoint molecule-wise).

    ``tri_extra_cols`` (triangular mode only): additionally count columns
    j < tri_extra_cols for every row.  Used by the row-restricted refresh
    pass — rows start at ``row_start`` and the skipped frozen-prefix rows
    [0, row_start) reappear as columns, so each active-frozen pair is
    still counted exactly once (its frozen member is never a row).
    """
    B = pos_i.shape[0]
    N = pos.shape[0]
    dr = pbc_ops.min_image(pos_i[:, None, :] - pos[None, :, :], box, box_inv)
    r2 = jnp.sum(dr * dr, axis=-1)                       # [B,N]

    cols = jnp.arange(N)
    pair_ok = row_valid[:, None] & alive[None, :]
    if triangular:
        tri = cols[None, :] > idx_i[:, None]
        if tri_extra_cols:
            tri = tri | (cols[None, :] < tri_extra_cols)
        pair_ok = pair_ok & tri
    if mol_of_rows is not None:
        # molecule pass: every row belongs to `mol_of_rows` — no gather
        same_mol = jnp.broadcast_to(
            params.mol_id[None, :] == mol_of_rows, pair_ok.shape)
    else:
        mol_i = params.mol_id[idx_i]
        same_mol = mol_i[:, None] == params.mol_id[None, :]
    inter = pair_ok & ~same_mol
    intra = pair_ok & same_mol
    within = r2 < rc * rc
    act = inter & within                                  # RD + ES-real pairs
    if split_frozen:
        atom_frozen = params.mol_frozen[params.mol_id]
        ff = atom_frozen[idx_i][:, None] & atom_frozen[None, :]   # [B,N]
    else:
        ff = None

    zero = jnp.zeros((), pos.dtype)
    rd_u, es_u, ex_u, tc = _tile_values(r2, idx_i, params, cfg, rc, alpha,
                                        temperature, row=row)

    def reduce_terms(keep, min_mask):
        def s(values, mask):
            if values is None:
                return zero
            m = mask if keep is None else (mask & keep)
            return jnp.sum(jnp.where(m, values, 0.0))
        return PairTerms(
            rd=s(rd_u, act), es_real=s(es_u, act), es_excl=s(ex_u, intra),
            lrc_coeff=s(tc, inter),
            min_r2=jnp.min(jnp.where(min_mask, r2, jnp.inf)))

    if not split_frozen:
        return reduce_terms(None, inter)
    # active part keeps the overlap tracker (framework self-overlap is
    # static geometry, not an MC rejection criterion)
    return reduce_terms(~ff, inter & ~ff), reduce_terms(ff, ff & inter)


def pair_pass(pos, box, atom_alive, params, cfg, temperature,
              split_frozen=False, row_start=0):
    """Full-system pair terms via a lax.scan over row blocks.

    The triangular mask counts each (i<j) pair once; the LRC coefficient is
    accumulated over *ordered inter pairs appearing once* (j>i), so the
    caller multiplies by 2 and adds the self (i==i image) term to get the
    full ordered-pair tail sum.

    With ``split_frozen`` returns (active, frozen_frozen) PairTerms.

    ``row_start`` (static) restricts the row scan to rows >= row_start,
    still paired triangularly against ALL columns.  When every frozen
    atom occupies a row < row_start (the frozen-prefix slot layout,
    metropolis.frozen_refresh_rows), this yields exactly the ACTIVE part
    of the split pass — every pair with at least one non-frozen member,
    once — at (N-row_start)/N of the cost, which is what the
    per-corrtime fast refresh uses to reuse the cached ``e_frozen``.

    XLA compiles the row-block scan below for every backend; it is also
    the f64 parity path.
    """
    if cfg.rd_crystal:
        # RD comes from the periodic-image lattice sum (ops/crystal.py);
        # ES/min_r2 bookkeeping stays on the cutoff pass.
        if cfg.rd_lrc:
            raise ValueError("rd_crystal implies rd_lrc off "
                             "(the image shells are the tail)")
        from mpmc_tpu.ops import crystal
        cfg_es = dataclasses.replace(cfg, rd_potential="none",
                                     rd_crystal=False,
                                     cdvdw_repulsion="none")
        if row_start:
            raise ValueError("row-restricted pair_pass does not support "
                             "rd_crystal (image-sum split differs)")
        base = pair_pass(pos, box, atom_alive, params, cfg_es, temperature,
                         split_frozen=split_frozen)
        cry = crystal.rd_crystal_full(pos, box, atom_alive, params, cfg,
                                      temperature, split_frozen=split_frozen)
        if split_frozen:
            act, ffp = base
            return (dataclasses.replace(act, rd=act.rd + cry[0]),
                    dataclasses.replace(ffp, rd=ffp.rd + cry[1]))
        return dataclasses.replace(base, rd=base.rd + cry)

    N = pos.shape[0]
    n_rows = N - row_start
    if n_rows <= 0:
        z = PairTerms.zero(pos.dtype)
        return (z, z) if split_frozen else z
    B = min(cfg.pair_chunk, n_rows)
    nb = -(-n_rows // B)
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)

    def body(acc, b):
        i0 = row_start + b * B
        idx = jnp.clip(i0 + jnp.arange(B), 0, N - 1)
        valid = (i0 + jnp.arange(B) < N) & atom_alive[idx]
        t = _block_terms(pos[idx], idx, valid, pos, atom_alive, params, cfg,
                         box, box_inv, rc, alpha, temperature,
                         triangular=True, split_frozen=split_frozen,
                         tri_extra_cols=row_start)
        if split_frozen:
            return (acc[0].combine(t[0]), acc[1].combine(t[1])), None
        return acc.combine(t), None

    z = PairTerms.zero(pos.dtype)
    init = (z, z) if split_frozen else z
    if cfg.spatial_axis is not None:
        # round-robin row blocks across the mesh (the triangular mask's
        # load balance trick from parallel/spatial.py): device d runs
        # blocks d, d+D, ...; out-of-range blocks fall out via the
        # valid mask, and the per-device partials meet in one psum
        axis, ndev = cfg.spatial_axis
        d = jax.lax.axis_index(axis)
        nb_l = -(-nb // ndev)
        acc, _ = jax.lax.scan(
            lambda a, bl: body(a, d + bl * ndev), init,
            jnp.arange(nb_l))
        if split_frozen:
            return (_spatial_combine(acc[0], axis),
                    _spatial_combine(acc[1], axis))
        return _spatial_combine(acc, axis)
    acc, _ = jax.lax.scan(body, init, jnp.arange(nb))
    return acc


def mol_pair_pass(pos, box, atom_alive, params, cfg, temperature, mol,
                  row_pos=None):
    """Pair terms between molecule ``mol``'s atoms and all *other* molecules.

    One-sided: each inter-molecular pair touching ``mol`` is counted exactly
    once.  This is the O(A_max * N) delta-energy workhorse (SURVEY.md §7
    step 3).  Intramolecular terms of ``mol`` itself are NOT included here
    (they are rigid-invariant for displace/rotate; GCMC handles them via
    ``intra_terms``).
    """
    if cfg.rd_crystal:
        from mpmc_tpu.ops import crystal
        cfg_es = dataclasses.replace(cfg, rd_potential="none",
                                     rd_crystal=False,
                                     cdvdw_repulsion="none")
        base = mol_pair_pass(pos, box, atom_alive, params, cfg_es,
                             temperature, mol, row_pos=row_pos)
        cry = crystal.mol_rd_crystal(pos, box, atom_alive, params, cfg,
                                     temperature, mol, row_pos=row_pos)
        return dataclasses.replace(base, rd=base.rd + cry)

    if cfg.cell_list and params.cell_index is not None:
        from mpmc_tpu.ops import celllist
        return celllist.mol_pair_pass_culled(
            pos, box, atom_alive, params, cfg, temperature, mol,
            params.cell_index, row_pos=row_pos)

    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)

    if cfg.spatial_axis is not None:
        # in-loop column sharding (config.RunConfig.spatial_axis): this
        # trace runs inside a shard_map with replicated state; each
        # device evaluates the moved rows against ITS column strip and
        # the scalars meet in one psum (min_r2 in one pmin) — identical
        # on every device, so the replicated chains stay in lockstep
        return _mol_pair_pass_spatial(pos, box, atom_alive, params, cfg,
                                      temperature, mol, row_pos,
                                      box_inv, rc, alpha)

    from mpmc_tpu.state import mol_rows as _mr
    na = params.mol_natoms[mol]
    valid = jnp.arange(params.max_atoms_per_mol) < na
    # exclude own molecule columns entirely (one-sided inter only)
    col_alive = atom_alive & (params.mol_id != mol)
    # row_pos: trial coordinates for the molecule's own rows.  The columns
    # always come from ``pos`` — for a displace trial the moved molecule's
    # columns are masked out anyway, so sharing the untouched array lets
    # XLA CSE every column gather between the old- and new-position passes.
    rows = _mr(pos, params, mol) if row_pos is None else row_pos
    return _block_terms(rows, None, valid, pos, col_alive, params, cfg,
                        box, box_inv, rc, alpha, temperature,
                        triangular=False, row=mol_row_params(params, mol),
                        mol_of_rows=mol)


def _spatial_combine(t: PairTerms, axis: str) -> PairTerms:
    """psum the scalar sums / pmin the overlap tracker of a device-local
    PairTerms (spatial_axis contract)."""
    return PairTerms(
        rd=jax.lax.psum(t.rd, axis),
        es_real=jax.lax.psum(t.es_real, axis),
        es_excl=jax.lax.psum(t.es_excl, axis),
        lrc_coeff=jax.lax.psum(t.lrc_coeff, axis),
        min_r2=jax.lax.pmin(t.min_r2, axis))


def _slice_atom_axis(params, pos, alive, start, nl):
    """(params', pos', alive') with every per-ATOM array replaced by a
    padded dynamic_slice [nl] starting at ``start`` (traced).  Padding
    rows arrive dead (alive False, mol_id sentinel), so tail overlap of
    the last strip contributes nothing."""
    n = pos.shape[0]
    pad = nl * ((n + nl - 1) // nl) - n

    def sl(x, fill=0.0):
        xp = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1),
                     constant_values=fill)
        return jax.lax.dynamic_slice_in_dim(xp, start, nl, axis=0)

    p2 = dataclasses.replace(
        params,
        charge=sl(params.charge), mass=sl(params.mass),
        polar=sl(params.polar), eps=sl(params.eps), sig=sl(params.sig),
        omega=sl(params.omega), c6=sl(params.c6), c8=sl(params.c8),
        c10=sl(params.c10), gwp_alpha=sl(params.gwp_alpha),
        mol_id=sl(params.mol_id, fill=-1),
        atom_ok=sl(params.atom_ok, fill=False))
    return p2, sl(pos), sl(alive, fill=False)


def _mol_pair_pass_spatial(pos, box, atom_alive, params, cfg,
                           temperature, mol, row_pos, box_inv, rc,
                           alpha):
    """Column-sharded molecule delta pass (see mol_pair_pass): each
    device processes columns [d nl, (d+1) nl) of the padded atom axis
    against the (replicated) moved rows, then the PairTerms combine
    with one psum/pmin.  cell lists / rd_crystal are unsupported
    under spatial_axis (run_chunk_spatial gate)."""
    from mpmc_tpu.state import mol_rows as _mr
    axis, ndev = cfg.spatial_axis
    n = pos.shape[0]
    nl = -(-n // ndev)
    d = jax.lax.axis_index(axis)
    na = params.mol_natoms[mol]
    valid = jnp.arange(params.max_atoms_per_mol) < na
    rows = _mr(pos, params, mol) if row_pos is None else row_pos
    row = mol_row_params(params, mol)
    p2, pos_l, alive_l = _slice_atom_axis(params, pos, atom_alive,
                                          d * nl, nl)
    col_alive = alive_l & (p2.mol_id != mol)
    t = _block_terms(rows, None, valid, pos_l, col_alive, p2, cfg,
                     box, box_inv, rc, alpha, temperature,
                     triangular=False, row=row, mol_of_rows=mol)
    return _spatial_combine(t, axis)


def intra_terms(pos, box, params, cfg, mol, row_pos=None):
    """Intramolecular terms of one molecule: the Ewald exclusion correction
    (-ke q_i q_j erf(alpha r)/r over its internal pairs).  Needed when a
    molecule appears/disappears (GCMC insert/delete).  ``row_pos``: trial
    rows (skips gathering from ``pos``)."""
    if cfg.coulomb != "ewald":
        return jnp.zeros((), pos.dtype)
    from mpmc_tpu.state import mol_rows as _mr
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)
    na = params.mol_natoms[mol]
    A = params.max_atoms_per_mol
    valid = jnp.arange(A) < na
    p = _mr(pos, params, mol) if row_pos is None else row_pos
    dr = pbc_ops.min_image(p[:, None, :] - p[None, :, :], box)
    r2 = jnp.sum(dr * dr, -1)
    tri = (jnp.arange(A)[None, :] > jnp.arange(A)[:, None])
    ok = tri & valid[:, None] & valid[None, :]
    r = jnp.sqrt(jnp.where(r2 > 1e-12, r2, 1.0))
    q = _mr(params.charge, params, mol)
    qq = q[:, None] * q[None, :]
    return -KE * jnp.sum(jnp.where(ok, qq * erf(alpha * r) / r, 0.0))


def lrc_self_coefficient(atom_alive, params, cfg, rc):
    """Self (i==i periodic images) tail term: sum_i T_ii over alive atoms."""
    if not cfg.rd_lrc:
        return jnp.zeros((), params.eps.dtype)
    if cfg.rd_potential == "lj":
        tc = lj_ops.tail_coefficient(params.eps, params.sig, rc)
    elif cfg.rd_potential == "disp_expansion":
        tc = potentials.disp_tail_coefficient(params.c6, params.c8,
                                              params.c10, rc)
    else:
        return jnp.zeros((), params.eps.dtype)
    return jnp.sum(jnp.where(atom_alive, tc, 0.0))


@dataclasses.dataclass(frozen=True)
class MolPartials:
    """Per-column-molecule partial sums of one molecule's pair pass —
    the unit of the molecule-pair energy cache (SURVEY.md §1 "delta
    energy": the reference's per-pair caching, lifted to molecule
    granularity so displace needs one pass and delete none)."""
    rd: jax.Array        # [M] sum of RD pair energies vs each molecule
    es_real: jax.Array   # [M]
    lrc: jax.Array       # [M] distance-independent tail coefficients
    min_r2: jax.Array    # scalar: closest approach (overlap check)


jax.tree_util.register_dataclass(MolPartials)


def mol_pair_partials(pos, box, atom_alive, params, cfg, temperature, mol,
                      row_pos=None) -> MolPartials:
    """Like mol_pair_pass, but reduced per *column molecule* instead of
    to scalars.  ``sum(p.rd)`` equals ``mol_pair_pass(...).rd`` etc."""
    from mpmc_tpu.state import mol_rows as _mr
    box_inv = jnp.linalg.inv(box)
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)
    na = params.mol_natoms[mol]
    valid = jnp.arange(params.max_atoms_per_mol) < na
    col_alive = atom_alive & (params.mol_id != mol)
    rows = _mr(pos, params, mol) if row_pos is None else row_pos

    dr = pbc_ops.min_image(rows[:, None, :] - pos[None, :, :], box, box_inv)
    r2 = jnp.sum(dr * dr, -1)                            # [A,N]
    inter = valid[:, None] & col_alive[None, :]
    act = inter & (r2 < rc * rc)
    rd_u, es_u, _, tc = _tile_values(r2, None, params, cfg, rc, alpha,
                                     temperature,
                                     row=mol_row_params(params, mol))

    M = params.n_mols_max

    def seg(values, mask):
        if values is None:
            return jnp.zeros((M,), pos.dtype)
        v = jnp.sum(jnp.where(mask, values, 0.0), axis=0)   # [N]
        return per_molecule_sums(v, params)

    return MolPartials(
        rd=seg(rd_u, act), es_real=seg(es_u, act), lrc=seg(tc, inter),
        min_r2=jnp.min(jnp.where(inter, r2, jnp.inf)))


def per_molecule_sums(v, params):
    """[N] -> [M]: sum of v over each molecule's (contiguous) atom range
    via one cumulative sum — a segmented reduction with no scatter
    (segment_sum's scatter lowering and 1-D gathers compiled very slowly
    on the backend this was first written for; the 2-D row-gather form
    below compiles in well under a second)."""
    cs = jnp.concatenate([jnp.zeros((1,), v.dtype), jnp.cumsum(v)])
    cs2 = cs.reshape(-1, 1)
    start = params.mol_start
    hi = cs2[start + params.mol_natoms][:, 0]
    lo = cs2[start][:, 0]
    return hi - lo


def pair_matrix(pos, box, atom_alive, params, cfg, temperature):
    """[M, M] symmetric molecule-pair energy matrices (rd, es_real,
    lrc_coeff): entry (m, o) is the total pair term between molecules m
    and o (each atom pair counted once; diagonal zero).

    Built once per run (metropolis.initialize) as a scan of row passes
    over the *movable* molecule slots (each O(A N)); the frozen
    framework's row (slot 0 — never a delta target itself, but read as
    a column of every sorbate row) is filled by symmetry.  Kept exactly
    current afterwards by the accept-time row/column scatters — entries
    are always whole pass outputs, never sums of increments, so the
    cache cannot drift.
    """
    M = params.n_mols_max

    def body(_, m):
        p = mol_pair_partials(pos, box, atom_alive, params, cfg,
                              temperature, m)
        # frozen rows are invalid (mol_atoms truncates the framework to
        # A entries) and dead slots must stay zero — mask both; frozen
        # rows are restored from their columns below
        ok = atom_alive[params.mol_start[m]] & ~params.mol_frozen[m]
        row = jnp.where(ok, 1.0, 0.0).astype(pos.dtype)
        return None, (row * p.rd, row * p.es_real, row * p.lrc)

    _, (r_rd, r_es, r_lrc) = jax.lax.scan(body, None, jnp.arange(M))
    frozen_row = params.mol_frozen[:, None]

    def assemble(c):
        return jnp.where(frozen_row, c.T, c)

    return assemble(r_rd), assemble(r_es), assemble(r_lrc)


def mol_lrc_self_coefficient(params, cfg, rc, mol):
    """Sum of self tail coefficients T_ii over one molecule's atoms
    (GCMC insert/delete LRC delta: dU_lrc = (molp.lrc_coeff +
    0.5 * this) / V)."""
    if not cfg.rd_lrc:
        return jnp.zeros((), params.eps.dtype)
    from mpmc_tpu.state import mol_rows as _mr
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    if cfg.cdvdw_repulsion != "none":
        s = _mr(params.sig, params, mol)
        a = _mr(params.polar, params, mol)
        w = _mr(params.omega, params, mol)
        tc = potentials.cdvdw_repulsion_tail_coefficient(
            s, s, a, a, w, w, rc, cfg)
    elif cfg.rd_potential == "lj":
        tc = lj_ops.tail_coefficient(_mr(params.eps, params, mol),
                                     _mr(params.sig, params, mol), rc)
    elif cfg.rd_potential == "disp_expansion":
        tc = potentials.disp_tail_coefficient(
            _mr(params.c6, params, mol), _mr(params.c8, params, mol),
            _mr(params.c10, params, mol), rc)
    else:
        return jnp.zeros((), params.eps.dtype)
    return jnp.sum(jnp.where(ok, tc, 0.0))
