"""Pallas-Triton kernel for the Thole polarization hot paths (GPU).

The reference's per-step bottleneck for polar systems is the dipole SCF
(SURVEY.md §3.2: "HOTTEST"; the one component it offloads to CUDA,
src/polarization/polar_cuda.cu [M]).  Its two O(N^2) passes become one
Triton kernel with a static ``mode``:

- ``dipole_field``: E_i = sum_j [3 d2 (dr.mu_j) dr / r^5 - d1 mu_j / r^3]
  (the matvec applied every CG/Jacobi iteration);
- ``charge_field``: E_i = sum_j q_j d1 dr / r^3 over intermolecular pairs
  (the static-field build).

One program owns a block of ``bi`` target sites and walks the column
blocks of ``bj`` source sites in a loop inside the program: it computes
the minimum-image displacements, damping and tensor contraction of each
(bi x bj) tile in registers and accumulates the three field components
of its rows there, so nothing of size [N, N] reaches device memory.

Every launch takes a flattened [NI*NJ] tile-visit table (all ones for
the dense pass).  A program skips the tiles marked 0, each by itself;
the caller guarantees that every pair in such a tile lies outside rc
(thole.cull_visit), so the skipped tile would have added exact zeros and
the culled field is bit-identical to the dense one.  Masks and formulas
mirror ops/thole.py (same damping), which stays the reference
implementation, the f64 parity path and the CPU path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# rows per program and columns per inner step (powers of two, as Triton
# requires); the tile-visit table of the culled matvec is built at the
# same granularity.  Chosen by tools/thole_bench.py --tune on an H100
# (10.8k sites): small tiles won both dense (0.73 ms vs 1.19 at 32x64)
# and culled at rc = 14 A (0.27 vs 0.35 ms) — PERF.md.
BI = 16
BJ = 32
NUM_WARPS = 4
NUM_STAGES = 2


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def grid_shape(n_real, bi=BI, bj=BJ):
    """(n_pad, n_row_blocks, n_col_blocks) for the given block sizes —
    the shape contract between a caller-built ``visit`` table and the
    kernel grid."""
    n_pad = _round_up(max(n_real, 1), max(bi, bj))
    return n_pad, n_pad // bi, n_pad // bj


def _damping(r, lam, kind):
    # mirrors ops/thole._damping (exponential = Thole model 3,
    # linear = Thole model 1)
    if kind == "none":
        one = jnp.ones_like(r)
        return one, one
    if kind == "linear":
        u = jnp.minimum(r / lam, 1.0)
        u3 = u * u * u
        return 4.0 * u3 - 3.0 * u3 * u, u3 * u
    x = lam * r
    e = jnp.exp(-x)
    p1 = 1.0 + x + 0.5 * x * x
    return 1.0 - e * p1, 1.0 - e * (p1 + x * x * x / 6.0)


# scal layout: [rc, lam, box (row-major 3x3), box^-1 (row-major 3x3)],
# padded to a power of two
_S_BOX, _S_BINV, _S_LEN = 2, 11, 32


def _kernel(scal_ref, x_ref, y_ref, z_ref, *refs, mode, damp_kind, ortho,
            bi, bj, nj):
    n_src = 1 if mode == "charge" else 3
    src_refs = refs[:n_src]
    ok_ref, mol_ref, visit_ref, ex_ref, ey_ref, ez_ref = refs[n_src:]
    i = pl.program_id(0)
    rows = pl.ds(i * bi, bi)
    rc = scal_ref[0]
    lam = scal_ref[1]
    box = [[scal_ref[_S_BOX + 3 * a + b] for b in range(3)]
           for a in range(3)]
    binv = [[scal_ref[_S_BINV + 3 * a + b] for b in range(3)]
            for a in range(3)]
    pi = [x_ref[rows], y_ref[rows], z_ref[rows]]
    ok_i = ok_ref[rows] > 0
    mol_i = mol_ref[rows]
    row_id = i * bi + jnp.arange(bi, dtype=jnp.int32)

    def tile(j, acc):
        cols = pl.ds(j * bj, bj)
        pj = [x_ref[cols], y_ref[cols], z_ref[cols]]
        dx = [pi[k][:, None] - pj[k][None, :] for k in range(3)]
        if ortho:
            # diagonal basis: the triclinic cross terms are exact zeros,
            # so dropping them leaves every displacement bit-identical
            fr = [dx[a] * binv[a][a] for a in range(3)]
            fr = [f - jnp.floor(f + 0.5) for f in fr]
            dr = [fr[a] * box[a][a] for a in range(3)]
        else:
            fr = [dx[0] * binv[0][a] + dx[1] * binv[1][a]
                  + dx[2] * binv[2][a] for a in range(3)]
            fr = [f - jnp.floor(f + 0.5) for f in fr]
            dr = [fr[0] * box[0][b] + fr[1] * box[1][b]
                  + fr[2] * box[2][b] for b in range(3)]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        col_id = j * bj + jnp.arange(bj, dtype=jnp.int32)
        ok = (ok_i[:, None] & (ok_ref[cols] > 0)[None, :]
              & (row_id[:, None] != col_id[None, :]) & (r2 < rc * rc))
        if mode == "charge":
            # static field: intermolecular only
            ok = ok & (mol_i[:, None] != mol_ref[cols][None, :])
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        inv_r = jax.lax.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        inv_r3 = inv_r2 * inv_r
        d1, d2 = _damping(r2s * inv_r, lam, damp_kind)
        if mode == "charge":
            coef = jnp.where(ok, src_refs[0][cols][None, :] * d1 * inv_r3,
                             0.0)
            e = [jnp.sum(coef * dr[k], axis=1) for k in range(3)]
        else:
            mu = [s[cols][None, :] for s in src_refs]
            mdotr = mu[0] * dr[0] + mu[1] * dr[1] + mu[2] * dr[2]
            c1 = jnp.where(ok, 3.0 * d2 * mdotr * inv_r3 * inv_r2, 0.0)
            c2 = jnp.where(ok, d1 * inv_r3, 0.0)
            e = [jnp.sum(c1 * dr[k] - c2 * mu[k], axis=1)
                 for k in range(3)]
        return tuple(a + b for a, b in zip(acc, e))

    def body(j, acc):
        return jax.lax.cond(visit_ref[i * nj + j] != 0,
                            lambda a: tile(j, a), lambda a: a, acc)

    zero = jnp.zeros((bi,), jnp.float32)
    ex, ey, ez = jax.lax.fori_loop(0, nj, body, (zero, zero, zero))
    ex_ref[rows] = ex
    ey_ref[rows] = ey
    ez_ref[rows] = ez


@functools.partial(jax.jit, static_argnames=(
    "mode", "damp_kind", "interpret", "ortho", "bi", "bj", "num_warps",
    "num_stages"))
def _field(pos, src, ok, mol_id, box, rc, lam, visit, *, mode, damp_kind,
           interpret=False, ortho=False, bi=BI, bj=BJ,
           num_warps=NUM_WARPS, num_stages=NUM_STAGES):
    f32 = jnp.float32
    n = pos.shape[0]
    n_pad, ni, nj = grid_shape(n, bi, bj)

    def pad(x, dt=f32):
        return jnp.pad(jnp.asarray(x).astype(dt), (0, n_pad - n))

    coords = [pad(pos[:, k]) for k in range(3)]
    srcs = ([pad(src)] if mode == "charge"
            else [pad(src[:, k]) for k in range(3)])
    box32 = box.astype(f32)
    scal = jnp.concatenate([jnp.stack([rc, lam]).astype(f32),
                            box32.reshape(9),
                            jnp.linalg.inv(box32).reshape(9)])
    scal = jnp.pad(scal, (0, _S_LEN - scal.shape[0]))
    if visit is None:
        visit = jnp.ones((ni * nj,), jnp.int32)
    else:
        visit = visit.astype(jnp.int32).reshape(ni * nj)
    out = pl.pallas_call(
        functools.partial(_kernel, mode=mode, damp_kind=damp_kind,
                          ortho=ortho, bi=bi, bj=bj, nj=nj),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), f32)] * 3,
        grid=(ni,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name=f"thole_{mode}_field",
    )(scal, *coords, *srcs, pad(ok, jnp.int32), pad(mol_id, jnp.int32),
      visit)
    return jnp.stack(out, axis=1)[:n]


def charge_field(pos, box, site_ok, charge, mol_id, rc, lam, damp_kind,
                 interpret=False, ortho=False, visit=None, **blocks):
    """Damped intermolecular static field [N,3] (no ke factor)."""
    return _field(pos, charge, site_ok, mol_id, box, rc, lam, visit,
                  mode="charge", damp_kind=damp_kind, interpret=interpret,
                  ortho=ortho, **blocks)


def dipole_field(pos, box, site_ok, mu, mol_id, rc, lam, damp_kind,
                 interpret=False, ortho=False, visit=None, **blocks):
    """(T mu) matvec [N,3].  ``visit``: optional conservative [NI,NJ]
    tile-visit table (see thole.cull_visit / grid_shape) — tiles marked
    0 are skipped whole; every pair they contain must already be
    outside rc, so the result is bit-identical to the dense pass."""
    return _field(pos, mu, site_ok, mol_id, box, rc, lam, visit,
                  mode="dipole", damp_kind=damp_kind, interpret=interpret,
                  ortho=ortho, **blocks)


def supported(cfg) -> bool:
    """The kernel computes in float32 and knows the three damping
    models; everything else takes the jnp reference."""
    return (cfg.dtype == "float32"
            and cfg.polar_damp_type in ("exponential", "linear", "none"))
