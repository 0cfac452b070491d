"""Static-framework cell lists: O(A * rc^3 rho) per-move delta energies.

The reference has NO neighbor structure at all — its pair loop is a true
O(N^2) over atom pairs (SURVEY.md §1 "No neighbor/cell lists").  For a
sorption workload, though, the overwhelming majority of atoms belong to a
FROZEN framework whose positions never change, so a spatial index over
them is exact and build-once:

- framework atoms (the fixed prefix [0, F) of the padded atom array) are
  re-sorted host-side into per-cell blocks of a fractional-coordinate
  grid — positions AND static parameters are stored in cell-major order
  inside the index, so a runtime query never gathers per-atom indices,
  only whole [cap]-wide cell blocks from arrays shared by every chain
  (~27 contiguous block gathers instead of thousands of element
  gathers from vmapped per-chain arrays);
- the default cell edge is ``cutoff + reach`` (reach = the largest
  template-atom-to-COM distance over all species), so the 3x3x3 block of
  cells around the moved molecule's COM provably covers every framework
  atom any row atom can see inside the cutoff — no skin, no rebuild,
  EXACT;
- sorbate slot atoms (the [F, N) tail — a small minority) are processed
  densely, so their motion needs no index maintenance.

The LJ/dispersion long-range-correction coefficient is the one term that
is NOT distance-limited; for the framework side it depends only on the
row atom's parameters, so it is precomputed per sorbate atom at build
time (``lrc_fw``), and only the small sorbate-sorbate part is summed at
run time.

Requires a user cutoff (``cutoff`` option) well below L/2 to pay off, a
frozen framework, and a fixed box (NVT/uVT — refused for NPT).  Enabled
by the ``cell_list`` input option (a documented extension to the
reference's §2.9 surface).  f64-exact: culled terms equal the dense
ops/pairs.mol_pair_pass to summation-order rounding — tests/test_celllist
enforces it, and the usual bookkeeping invariants run with it enabled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpmc_tpu.constants import KE
from mpmc_tpu.ops import lj as lj_ops
from mpmc_tpu.ops import pbc as pbc_ops
from mpmc_tpu.ops import potentials


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CellIndex:
    # cell-major framework data, [nc, cap(,3)] — shared across chains
    fw_pos: jax.Array
    fw_valid: jax.Array
    fw_q: jax.Array
    fw_eps: jax.Array
    fw_sig: jax.Array
    fw_c6: jax.Array
    fw_c8: jax.Array
    fw_c10: jax.Array
    fw_gwp: jax.Array
    offsets: jax.Array      # [K, 3] int32 cell offsets covering rc + reach
    lrc_fw: jax.Array       # [N] per-atom tail-coefficient sum vs framework
    fw_mass: jax.Array      # scalar: framework molecule total mass (FH)
    grid: tuple = dataclasses.field(metadata=dict(static=True),
                                    default=(1, 1, 1))
    n_frozen: int = dataclasses.field(metadata=dict(static=True), default=0)


def _species_reach(params) -> float:
    """Max template-atom distance from the *unweighted site centroid* of
    each species.  The runtime cell query (mol_pair_pass_culled) centers
    its 3^3 neighborhood on the unweighted mean of the molecule's rows,
    so coverage is only provable when reach is measured from that same
    point — NOT from the mass-weighted COM the templates are stored
    around (they differ for species with off-center massless sites)."""
    sp = np.asarray(params.species_pos, np.float64)   # [S, A, 3]
    sn = np.asarray(params.species_natoms)
    reach = 0.0
    for s in range(sp.shape[0]):
        a = int(sn[s])
        if a:
            cen = sp[s, :a].mean(axis=0)
            reach = max(reach,
                        float(np.linalg.norm(sp[s, :a] - cen, axis=1).max()))
    return reach


def build_cell_index(params, pos, box, cfg,
                     cell_edge: Optional[float] = None,
                     min_reduction: Optional[float] = 0.8,
                     pad_cap: int = 8):
    """Host-side construction of the framework cell index.  Returns None
    when culling cannot apply (no frozen framework, no explicit cutoff,
    or — unless ``min_reduction`` is None — the covered-cell set is not
    meaningfully smaller than F)."""
    if cfg.ensemble == "npt":
        raise ValueError("cell_list requires a fixed box (not npt)")
    if cfg.cutoff is None:
        return None
    if cfg.cdvdw_repulsion != "none":
        return None   # the culled tile pass has no Drude-repulsion branch
    mol_frozen = np.asarray(params.mol_frozen)
    if not mol_frozen.any():
        return None
    F = int(np.asarray(params.mol_natoms)[0])
    if F == 0:
        return None

    box = np.asarray(box, np.float64)
    pos = np.asarray(pos, np.float64)
    rc = float(cfg.cutoff)
    reach = _species_reach(params)
    R = rc + reach + 1e-9

    vol = abs(np.linalg.det(box))
    w = np.array([vol / np.linalg.norm(np.cross(box[1], box[2])),
                  vol / np.linalg.norm(np.cross(box[2], box[0])),
                  vol / np.linalg.norm(np.cross(box[0], box[1]))])
    # default: cell edge >= R so the 3^3 neighborhood always suffices —
    # block gathers are the runtime cost, so fewer/fatter cells win
    e = cell_edge if cell_edge is not None else R * 1.001
    G = np.maximum(1, (w / e).astype(int))

    offs_axes = []
    for a in range(3):
        cr = int(np.floor(R * G[a] / w[a])) + 1
        if 2 * cr + 1 >= G[a]:
            offs_axes.append(np.arange(int(G[a])))
        else:
            offs_axes.append(np.arange(-cr, cr + 1))
    offsets = np.stack(np.meshgrid(*offs_axes, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.int32)

    # bucket framework atoms by fractional cell
    frac = (pos[:F] @ np.linalg.inv(box)) % 1.0
    cell3 = np.minimum((frac * G).astype(int), G - 1)
    flat = (cell3[:, 0] * G[1] + cell3[:, 1]) * G[2] + cell3[:, 2]
    nc = int(G[0] * G[1] * G[2])
    counts = np.bincount(flat, minlength=nc)
    cap = int(-(-max(1, counts.max()) // pad_cap) * pad_cap)
    if (min_reduction is not None
            and offsets.shape[0] * cap >= min_reduction * F):
        return None   # no meaningful reduction — dense path is fine

    def blk(src, d3=False):
        out = np.zeros((nc, cap, 3) if d3 else (nc, cap), np.float64)
        return out

    fw_pos = blk(None, d3=True)
    fw_valid = np.zeros((nc, cap), bool)
    per_atom = {k: blk(None) for k in
                ("q", "eps", "sig", "c6", "c8", "c10", "gwp")}
    src = {"q": np.asarray(params.charge, np.float64),
           "eps": np.asarray(params.eps, np.float64),
           "sig": np.asarray(params.sig, np.float64),
           "c6": np.asarray(params.c6, np.float64),
           "c8": np.asarray(params.c8, np.float64),
           "c10": np.asarray(params.c10, np.float64),
           "gwp": np.asarray(params.gwp_alpha, np.float64)}
    fill = np.zeros(nc, np.int64)
    for i in range(F):
        c = flat[i]
        k = fill[c]
        fw_pos[c, k] = pos[i]
        fw_valid[c, k] = True
        for name in per_atom:
            per_atom[name][c, k] = src[name][i]
        fill[c] += 1

    lrc_fw = _framework_lrc_table(params, cfg, rc, F)
    dt = params.eps.dtype
    return CellIndex(
        fw_pos=jnp.asarray(fw_pos, dt),
        fw_valid=jnp.asarray(fw_valid),
        fw_q=jnp.asarray(per_atom["q"], dt),
        fw_eps=jnp.asarray(per_atom["eps"], dt),
        fw_sig=jnp.asarray(per_atom["sig"], dt),
        fw_c6=jnp.asarray(per_atom["c6"], dt),
        fw_c8=jnp.asarray(per_atom["c8"], dt),
        fw_c10=jnp.asarray(per_atom["c10"], dt),
        fw_gwp=jnp.asarray(per_atom["gwp"], dt),
        offsets=jnp.asarray(offsets),
        lrc_fw=jnp.asarray(lrc_fw, dt),
        fw_mass=jnp.asarray(params.mol_mass[0], dt),
        grid=tuple(int(g) for g in G), n_frozen=F)


def _framework_lrc_table(params, cfg, rc, F):
    """lrc_fw[i] = sum over framework atoms j of the tail coefficient
    T(mix(i, j)) — the framework side of the delta pass's lrc_coeff,
    which is distance-independent and so survives culling as a
    precomputed per-atom constant."""
    N = params.eps.shape[0]
    if not cfg.rd_lrc or cfg.rd_potential not in ("lj", "disp_expansion"):
        return np.zeros(N)
    eps = np.asarray(params.eps, np.float64)
    sig = np.asarray(params.sig, np.float64)
    c6 = np.asarray(params.c6, np.float64)
    c8 = np.asarray(params.c8, np.float64)
    c10 = np.asarray(params.c10, np.float64)
    keys = np.stack([eps, sig, c6, c8, c10], 1)
    uniq, inv = np.unique(keys.round(12), axis=0, return_inverse=True)
    out_t = np.zeros(len(uniq))
    for t in range(len(uniq)):
        ei, si_, c6i, c8i, c10i = uniq[t]
        if cfg.rd_potential == "lj":
            em, sm = lj_ops.mix(ei, eps[:F], si_, sig[:F], cfg.mixing_rule)
            tc = np.asarray(lj_ops.tail_coefficient(em, sm, rc))
        else:
            c6m = np.sqrt(np.maximum(c6i * c6[:F], 0.0))
            c8m = np.sqrt(np.maximum(c8i * c8[:F], 0.0))
            c10m = np.sqrt(np.maximum(c10i * c10[:F], 0.0))
            tc = np.asarray(potentials.disp_tail_coefficient(
                c6m, c8m, c10m, rc))
        out_t[t] = tc.sum()
    return out_t[inv]


def attach(params, pos, box, cfg, cell_edge: Optional[float] = None,
           min_reduction: Optional[float] = 0.8):
    """Build and attach the framework cell index (host-side; call once
    after build_system).  No-op returning ``params`` unchanged when
    culling cannot apply."""
    ci = build_cell_index(params, pos, box, cfg, cell_edge, min_reduction)
    if ci is None:
        return params
    return dataclasses.replace(params, cell_index=ci)


# ---------------------------------------------------------------------------
# Culled delta pass
# ---------------------------------------------------------------------------

def _tile_terms(rows_pos, row_valid, r_eps, r_sig, r_q, r_c6, r_c8, r_c10,
                r_gwp, r_mm, cols_pos, col_ok, c_eps, c_sig, c_q, c_c6,
                c_c8, c_c10, c_gwp, c_mm, box, box_inv, rc, alpha, cfg,
                temperature, want_tail):
    """rd/es/tail/min_r2 sums for explicit row [A] x column [C] arrays.
    Mirrors ops/pairs._block_terms with one-sided (non-triangular)
    counting; the caller guarantees rows and columns are
    molecule-disjoint."""
    dr = pbc_ops.min_image(rows_pos[:, None, :] - cols_pos[None, :, :],
                           box, box_inv)
    r2 = jnp.sum(dr * dr, -1)
    ok = row_valid[:, None] & col_ok[None, :]
    act = ok & (r2 < rc * rc)
    r2s = jnp.where(r2 > 1e-12, r2, 1.0)
    r = jnp.sqrt(r2s)
    zero = jnp.zeros((), rows_pos.dtype)

    re = lambda x: x[:, None]
    ce = lambda x: x[None, :]
    rd_u = None
    tc = None
    if cfg.rd_potential == "lj":
        eps, sig = lj_ops.mix(re(r_eps), ce(c_eps), re(r_sig), ce(c_sig),
                              cfg.mixing_rule)
        rd_u = lj_ops.energy(r2s, eps, sig)
        if cfg.feynman_hibbs or cfg.feynman_kleinert:
            red = (re(r_mm) * ce(c_mm)
                   / jnp.maximum(re(r_mm) + ce(c_mm), 1e-30))
            if cfg.feynman_kleinert:
                rd_u = rd_u + lj_ops.feynman_kleinert(r, eps, sig, red,
                                                      temperature)
            else:
                rd_u = rd_u + lj_ops.feynman_hibbs(
                    r, eps, sig, red, temperature, cfg.feynman_hibbs_order)
        if want_tail:
            tc = lj_ops.tail_coefficient(eps, sig, rc)
    elif cfg.rd_potential in ("sg", "dreiding", "b14_7", "disp_expansion"):
        rd_u = potentials.rd_pair_energy_generic(
            r, re(r_eps), ce(c_eps), re(r_sig), ce(c_sig), re(r_c6),
            ce(c_c6), re(r_c8), ce(c_c8), re(r_c10), ce(c_c10), cfg)
        if want_tail and cfg.rd_potential == "disp_expansion":
            c6m = jnp.sqrt(jnp.maximum(re(r_c6) * ce(c_c6), 0.0))
            c8m = jnp.sqrt(jnp.maximum(re(r_c8) * ce(c_c8), 0.0))
            c10m = jnp.sqrt(jnp.maximum(re(r_c10) * ce(c_c10), 0.0))
            tc = potentials.disp_tail_coefficient(c6m, c8m, c10m, rc)

    es_u = None
    qq = re(r_q) * ce(c_q)
    from jax.scipy.special import erf, erfc
    if cfg.coulomb == "ewald":
        es_u = KE * qq * erfc(alpha * r) / r
    elif cfg.coulomb == "wolf":
        es_u = KE * qq * (erfc(alpha * r) / r - erfc(alpha * rc) / rc)
    elif cfg.coulomb == "cutoff":
        es_u = KE * qq / r
    elif cfg.coulomb == "gwp":
        s2 = re(r_gwp) ** 2 + ce(c_gwp) ** 2
        smear = jnp.where(s2 > 1e-12,
                          erf(r / jnp.sqrt(2.0 * jnp.maximum(s2, 1e-12))),
                          1.0)
        es_u = KE * qq * smear / r

    s = lambda v, m: zero if v is None else jnp.sum(jnp.where(m, v, 0.0))
    return (s(rd_u, act), s(es_u, act), s(tc, ok),
            jnp.min(jnp.where(ok, r2, jnp.inf)))


def mol_pair_pass_culled(pos, box, atom_alive, params, cfg, temperature,
                         mol, index: CellIndex, row_pos=None):
    """Culled equivalent of ops/pairs.mol_pair_pass: one molecule's rows
    against (a) the framework cell blocks around its COM, gathered from
    the index's shared cell-major tables, and (b) all sorbate slot
    columns densely."""
    from mpmc_tpu.ops.pairs import PairTerms, derived_alpha
    dtype = pos.dtype
    box_inv = jnp.linalg.inv(box)
    rc = jnp.asarray(cfg.cutoff, dtype)
    alpha = derived_alpha(rc, cfg)
    F = index.n_frozen
    G = index.grid

    from mpmc_tpu.state import mol_rows as _mr
    na = params.mol_natoms[mol]
    A = params.max_atoms_per_mol
    row_valid = jnp.arange(A) < na
    rows_pos = _mr(pos, params, mol) if row_pos is None else row_pos
    w = row_valid.astype(dtype)
    com = (jnp.sum(jnp.where(row_valid[:, None], rows_pos, 0.0), 0)
           / jnp.maximum(jnp.sum(w), 1.0))

    ga = lambda arr: _mr(arr, params, mol)
    r_mm = jnp.broadcast_to(params.mol_mass[mol], (A,))

    # --- framework block: K cell blocks around the COM ----------------------
    f = pbc_ops._apply33(com, box_inv) % 1.0
    gvec = jnp.asarray(G, jnp.int32)
    qc = jnp.minimum((f * gvec.astype(dtype)).astype(jnp.int32), gvec - 1)
    cells = (qc[None, :] + index.offsets) % gvec          # [K,3]
    flat = (cells[:, 0] * G[1] + cells[:, 1]) * G[2] + cells[:, 2]
    blk = lambda t: t[flat].reshape((-1,) + t.shape[2:])  # [K*cap, ...]
    fw_mm = jnp.broadcast_to(index.fw_mass, (flat.shape[0]
                                             * index.fw_pos.shape[1],))
    fw_rd, fw_es, _, fw_min = _tile_terms(
        rows_pos, row_valid, ga(params.eps), ga(params.sig),
        ga(params.charge), ga(params.c6), ga(params.c8), ga(params.c10),
        ga(params.gwp_alpha), r_mm,
        blk(index.fw_pos), blk(index.fw_valid), blk(index.fw_eps),
        blk(index.fw_sig), blk(index.fw_q), blk(index.fw_c6),
        blk(index.fw_c8), blk(index.fw_c10), blk(index.fw_gwp), fw_mm,
        box, box_inv, rc, alpha, cfg, temperature, want_tail=False)

    # --- sorbate block: dense over the [F, N) tail --------------------------
    want_tail = (cfg.rd_lrc
                 and cfg.rd_potential in ("lj", "disp_expansion"))
    s_alive = (atom_alive[F:] & (params.mol_id[F:] != mol))
    sb = lambda arr: arr[F:]
    sb_rd, sb_es, sb_tc, sb_min = _tile_terms(
        rows_pos, row_valid, ga(params.eps), ga(params.sig),
        ga(params.charge), ga(params.c6), ga(params.c8), ga(params.c10),
        ga(params.gwp_alpha), r_mm,
        pos[F:], s_alive, sb(params.eps), sb(params.sig), sb(params.charge),
        sb(params.c6), sb(params.c8), sb(params.c10), sb(params.gwp_alpha),
        params.mol_mass[params.mol_id[F:]],
        box, box_inv, rc, alpha, cfg, temperature, want_tail=want_tail)

    lrc_coeff = sb_tc
    if want_tail:
        lrc_coeff = lrc_coeff + jnp.sum(
            jnp.where(row_valid, _mr(index.lrc_fw, params, mol), 0.0))
    return PairTerms(rd=fw_rd + sb_rd, es_real=fw_es + sb_es,
                     es_excl=jnp.zeros((), dtype), lrc_coeff=lrc_coeff,
                     min_r2=jnp.minimum(fw_min, sb_min))
