"""Atom-sharded (spatial) parallel energy evaluation over a device mesh.

The reference has NO domain decomposition — its MPI axis is replicas only
(SURVEY.md §2 "Parallelism strategies": "Domain/spatial decomposition
(TP/PP analog): No").  This module goes beyond reference parity: the
O(N^2) pair matrix is tiled by ROW BLOCKS across mesh devices under
``shard_map`` — each device evaluates its row-block strip of the
half-matrix against the full (replicated) position array and the scalar
partial sums meet in one ``psum`` between devices.  The Ewald reciprocal term
shards over k-vectors the same way.  This is the "shard the pair
tile-grid" design from SURVEY.md §5 ("the ring attention of MC") and is
what scales a SINGLE huge system (10^5+ atoms) across chips, orthogonal
to replica parallelism.

Row blocks are interleaved round-robin (device d owns rows d, d+D,
d+2D, ...) so the triangular mask's load stays balanced.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mpmc_tpu.ops import ewald, pairs, pbc, thole
from mpmc_tpu.ops.pairs import PairTerms

AXIS = "atoms"


def default_mesh(n_devices=None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def pair_pass_sharded(pos, box, atom_alive, params, cfg, temperature,
                      mesh: Mesh):
    """Full-system PairTerms with row blocks sharded over the mesh.

    Equivalent to ops/pairs.pair_pass (triangular i<j counting); each
    device holds a replicated copy of positions and reduces only scalars
    — communication is one psum of ~5 numbers.
    """
    ndev = mesh.shape[AXIS]
    N = pos.shape[0]
    rows_per = -(-N // ndev)

    def local(pos_l, box_l, alive_l):
        d = jax.lax.axis_index(AXIS)
        box_inv = jnp.linalg.inv(box_l)
        rc = pairs.derived_cutoff(box_l, cfg)
        alpha = pairs.derived_alpha(rc, cfg)
        B = min(cfg.pair_chunk, rows_per)
        nb = -(-rows_per // B)

        def body(acc, b):
            # interleaved rows: this device's k-th row is d + k*ndev
            k0 = b * B
            local_k = k0 + jnp.arange(B)
            rows = d + local_k * ndev
            idx = jnp.clip(rows, 0, N - 1)
            valid = (local_k < rows_per) & (rows < N) & alive_l[idx]
            t = pairs._block_terms(
                pos_l[idx], idx, valid, pos_l, alive_l, params, cfg,
                box_l, box_inv, rc, alpha, temperature, triangular=True)
            return acc.combine(t), None

        acc, _ = jax.lax.scan(body, PairTerms.zero(pos_l.dtype),
                              jnp.arange(nb))
        return PairTerms(
            rd=jax.lax.psum(acc.rd, AXIS),
            es_real=jax.lax.psum(acc.es_real, AXIS),
            es_excl=jax.lax.psum(acc.es_excl, AXIS),
            lrc_coeff=jax.lax.psum(acc.lrc_coeff, AXIS),
            min_r2=-jax.lax.pmax(-acc.min_r2, AXIS))

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                      out_specs=P(), check_vma=False)
    return f(pos, box, atom_alive)


def recip_energy_sharded(pos, charge, alive, box, alpha, kmax,
                         mesh: Mesh):
    """Ewald reciprocal energy with the k-vector table sharded over the
    mesh: each device computes its strip of the structure factor and the
    weighted |S(k)|^2 partial sum; one psum of a scalar."""
    ndev = mesh.shape[AXIS]
    ints = ewald.half_space_ints(kmax)
    K = len(ints)
    k_pad = -(-K // ndev) * ndev
    ints_p = np.pad(ints, ((0, k_pad - K), (0, 0)))
    ok = np.arange(k_pad) < K
    ints_j = jnp.asarray(ints_p, pos.dtype)
    ok_j = jnp.asarray(ok)

    def local(pos_l, charge_l, alive_l, box_l, ints_l, ok_l):
        recip = 2.0 * jnp.pi * jnp.linalg.inv(box_l).T
        kv = ints_l @ recip
        q = jnp.where(alive_l, charge_l, 0.0)
        phase = pos_l @ kv.T
        sk_re = q @ jnp.cos(phase)
        sk_im = q @ jnp.sin(phase)
        v = jnp.abs(jnp.linalg.det(box_l))
        k2 = jnp.sum(kv * kv, axis=-1)
        w = jnp.where(ok_l, jnp.exp(-k2 / (4.0 * alpha * alpha))
                      / jnp.where(k2 > 0, k2, 1.0), 0.0)
        from mpmc_tpu.constants import KE
        e = KE * (2.0 * jnp.pi / v) * 2.0 * jnp.sum(
            w * (sk_re * sk_re + sk_im * sk_im))
        return jax.lax.psum(e, AXIS)

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS), P(AXIS)),
        out_specs=P(), check_vma=False)
    return f(pos, charge, alive, box, ints_j, ok_j)


def static_field_sharded(pos, box, atom_alive, params, cfg, mesh: Mesh):
    """Damped direct-cutoff static field E0 (ops/thole.static_field_direct)
    with target-row strips sharded over the mesh; one [N,3] psum."""
    ndev = mesh.shape[AXIS]
    N = pos.shape[0]
    rows_per = -(-N // ndev)

    def local(pos_l, box_l, alive_l):
        d = jax.lax.axis_index(AXIS)
        box_inv = jnp.linalg.inv(box_l)
        rc = pairs.derived_cutoff(box_l, cfg)
        B = min(cfg.pair_chunk, rows_per)
        nb = -(-rows_per // B)

        def body(_, bk):
            local_k = bk * B + jnp.arange(B)
            rows = d + local_k * ndev
            idx = jnp.clip(rows, 0, N - 1)
            rok = (rows < N) & alive_l[idx]
            dr = pbc.min_image(pos_l[idx][:, None, :] - pos_l[None, :, :],
                               box_l, box_inv)
            r2 = jnp.sum(dr * dr, -1)
            ok = (rok[:, None] & alive_l[None, :]
                  & (params.mol_id[idx][:, None]
                     != params.mol_id[None, :])
                  & (r2 < rc * rc))
            r2s = jnp.where(r2 > 1e-12, r2, 1.0)
            r = jnp.sqrt(r2s)
            d1, _ = thole._damping(r, cfg.polar_damp, cfg.polar_damp_type)
            coef = jnp.where(ok, params.charge[None, :] * d1 / (r2s * r),
                             0.0)
            return None, jnp.einsum("bn,bnk->bk", coef, dr)

        _, ys = jax.lax.scan(body, None, jnp.arange(nb))
        ys = ys.reshape(nb * B, 3)[:rows_per]
        plane = jnp.zeros((rows_per, ndev, 3), pos_l.dtype)
        zero = jnp.zeros((), d.dtype)
        plane = jax.lax.dynamic_update_slice(plane, ys[:, None, :],
                                             (zero, d, zero))
        return jax.lax.psum(plane.reshape(-1, 3)[:N], AXIS)

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                      out_specs=P(), check_vma=False)
    return f(pos, box, atom_alive)


def te_supported(cfg) -> bool:
    """Static gate for total_energy_sharded: every O(N^2)/O(N*K) pass of
    the config must have a sharded implementation.  cdvdw needs a dense
    eigensolve (no sharded variant); the Ewald/Wolf static-field
    variants keep their single-device path for E0 (the SCF itself still
    shards), so only cdvdw falls back entirely."""
    return not cfg.cdvdw


def total_energy_sharded(pos, box, mol_alive, params, cfg, thermo,
                         mesh: Mesh):
    """Single-point full-system energy with the O(N^2) pair matrix, the
    Ewald k-table, and the polar SCF matvec sharded over the mesh —
    the multi-chip `ensemble te` path (input option ``spatial_devices``).

    Matches ops/energy.total_energy's non-split path term by term
    (EnergyBreakdown); communication is one scalar psum for the pair
    terms, one for the recip sum, and one [N,3] psum per CG iteration.
    Per-move MC deltas deliberately stay single-device: they are O(A*N)
    and latency-bound, so collective latency would dominate (SURVEY.md
    §5 "long-context analog" — sharding is for full-pass recomputes).
    """
    from mpmc_tpu.state import EnergyBreakdown

    if not te_supported(cfg):
        from mpmc_tpu.ops import energy as energy_mod
        return energy_mod.total_energy(pos, box, mol_alive, params, cfg,
                                       thermo)
    dtype = pos.dtype
    alive = mol_alive[params.mol_id] & params.atom_ok
    zero = jnp.zeros((), dtype)
    aux = {}

    pt = pair_pass_sharded(pos, box, alive, params, cfg,
                           thermo.temperature, mesh)
    rc = pairs.derived_cutoff(box, cfg)
    volume = jnp.abs(jnp.linalg.det(box))

    lrc = zero
    if cfg.rd_potential in ("lj", "disp_expansion") and cfg.rd_lrc:
        sc = pairs.lrc_self_coefficient(alive, params, cfg, rc)
        lrc = (pt.lrc_coeff + 0.5 * sc) / volume

    es_recip = zero
    es_self = zero
    if cfg.coulomb == "ewald":
        alpha = pairs.derived_alpha(rc, cfg)
        es_recip = recip_energy_sharded(pos, params.charge, alive, box,
                                        alpha, cfg.ewald_kmax, mesh)
        es_self = ewald.self_energy(params.charge, alive, alpha)
    elif cfg.coulomb == "wolf":
        alpha = pairs.derived_alpha(rc, cfg)
        es_self = ewald.wolf_self_energy(params.charge, alive, alpha, rc)

    polar = zero
    if cfg.polarization:
        if cfg.polar_ewald or cfg.polar_wolf:
            e0 = thole.static_field(pos, box, alive, params, cfg)
        else:
            e0 = static_field_sharded(pos, box, alive, params, cfg, mesh)
        mu, n_iter = solve_scf_sharded(pos, box, alive, params, cfg, e0,
                                       mesh)
        polar = thole.polar_energy(mu, e0)
        aux["mu"], aux["e0"], aux["polar_iters"] = mu, e0, n_iter

    e = EnergyBreakdown(rd=pt.rd, lrc=lrc, es_real=pt.es_real,
                        es_recip=es_recip, es_self=es_self,
                        es_excl=pt.es_excl, polar=polar, vdw=zero)
    return e, aux


def solve_scf_sharded(pos, box, atom_alive, params, cfg, e0, mesh: Mesh,
                      mu0=None):
    """Thole SCF (ops/thole.solve_scf, PCG branch) with the O(N'^2)
    dipole matvec row blocks sharded over the mesh.

    The matvec is the chip-saturating term of the polarizable workload
    (SURVEY.md §3.2 HOTTEST; CLAUDE.md: batching buys nothing at C=1),
    so spatial sharding is the ONLY axis that scales one large
    polarizable system across chips.  Each device evaluates the damped
    dipole field on its round-robin row strip (rows d, d+D, ...) against
    the full replicated dipole vector; strips meet in one psum of the
    [N,3] field per CG iteration (~N*12 bytes between devices — trivial
    next to the O(N^2/D) flops).  The CG state itself stays replicated: every
    device runs the identical scalar recurrence, so no further
    communication is needed.

    Exact same fixed point, preconditioner (Jacobi z = alpha*r), and
    stopping criterion as the single-device solver; the only difference
    is float summation order inside the matvec.  Returns (mu [N,3],
    n_iter), both replicated.
    """
    ndev = mesh.shape[AXIS]
    N = pos.shape[0]
    rows_per = -(-N // ndev)
    if mu0 is None:
        mu0 = jnp.zeros_like(e0)

    def local(pos_l, box_l, alive_l, e0_l, mu0_l):
        d = jax.lax.axis_index(AXIS)
        box_inv = jnp.linalg.inv(box_l)
        rc = thole.derived_cutoff(box_l, cfg)
        pol_ok = alive_l & (params.polar > 0)
        mask = pol_ok[:, None]
        inv_a = jnp.where(pol_ok,
                          1.0 / jnp.maximum(params.polar, 1e-30),
                          0.0)[:, None]
        alpha_site = jnp.where(mask, params.polar[:, None], 0.0)
        b = jnp.where(mask, e0_l, 0.0)
        nsites = jnp.maximum(jnp.sum(pol_ok), 1)
        tol2 = (cfg.polar_precision ** 2) * nsites * 3
        B = min(cfg.pair_chunk, rows_per)
        nb = -(-rows_per // B)

        def tmul(x):
            # rows d::ndev of (T x); assembled WITHOUT gather/scatter
            # (backend landmine, CLAUDE.md): strip k lands at flat row
            # k*ndev + d, so a [rows_per, ndev, 3] plane updated at
            # column d reshapes straight into atom order.
            def body(_, bk):
                local_k = bk * B + jnp.arange(B)
                rows = d + local_k * ndev
                idx = jnp.clip(rows, 0, N - 1)
                rok = (rows < N) & pol_ok[idx]
                dr = pbc.min_image(
                    pos_l[idx][:, None, :] - pos_l[None, :, :],
                    box_l, box_inv)
                r2 = jnp.sum(dr * dr, -1)
                diag = idx[:, None] == jnp.arange(N)[None, :]
                ok = (rok[:, None] & pol_ok[None, :] & ~diag
                      & (r2 < rc * rc))
                r2s = jnp.where(r2 > 1e-12, r2, 1.0)
                r = jnp.sqrt(r2s)
                d1, d2 = thole._damping(r, cfg.polar_damp,
                                        cfg.polar_damp_type)
                inv_r3 = 1.0 / (r2s * r)
                mdotr = jnp.einsum("nk,bnk->bn", x, dr)
                t1 = (3.0 * d2 * mdotr * inv_r3 / r2s)[..., None] * dr
                t2 = (d1 * inv_r3)[..., None] * x[None, :, :]
                return None, jnp.sum(
                    jnp.where(ok[..., None], t1 - t2, 0.0), axis=1)

            _, ys = jax.lax.scan(body, None, jnp.arange(nb))
            ys = ys.reshape(nb * B, 3)[:rows_per]
            plane = jnp.zeros((rows_per, ndev, 3), x.dtype)
            zero = jnp.zeros((), d.dtype)
            plane = jax.lax.dynamic_update_slice(
                plane, ys[:, None, :], (zero, d, zero))
            return jax.lax.psum(plane.reshape(-1, 3)[:N], AXIS)

        def amul(x):
            x = jnp.where(mask, x, 0.0)
            return jnp.where(mask, inv_a * x - tmul(x), 0.0)

        x = jnp.where(mask, mu0_l, 0.0)
        r = b - amul(x)
        z = alpha_site * r
        p = z
        rs = jnp.sum(r * r)
        rz = jnp.sum(r * z)

        def cond(carry):
            _x, _r, _p, rs_c, _rz, it = carry
            return (it < cfg.polar_max_iter) & (rs_c > tol2)

        def step(carry):
            x_c, r_c, p_c, rs_c, rz_c, it = carry
            ap = amul(p_c)
            denom = jnp.sum(p_c * ap)
            al = rz_c / jnp.where(jnp.abs(denom) > 1e-300, denom, 1e-300)
            x_c = x_c + al * p_c
            r_c = r_c - al * ap
            z_c = alpha_site * r_c
            rz_new = jnp.sum(r_c * z_c)
            beta = rz_new / jnp.where(jnp.abs(rz_c) > 1e-300, rz_c,
                                      1e-300)
            return (x_c, r_c, z_c + beta * p_c, jnp.sum(r_c * r_c),
                    rz_new, it + 1)

        x, r, p, rs, rz, it = jax.lax.while_loop(
            cond, step, (x, r, p, rs, rz, jnp.zeros((), jnp.int32)))
        return jnp.where(mask, x, 0.0), it

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(), P(), P(), P()),
                      out_specs=(P(), P()), check_vma=False)
    return f(pos, box, atom_alive, e0, mu0)


# --------------------------------------------------------------------------
# In-loop spatial sharding of the MC step itself (r2 verdict item 3):
# state REPLICATED, per-move O(A N) column pass and per-refresh O(N^2)
# row pass sharded over the mesh (config.RunConfig.spatial_axis —
# ops/pairs.mol_pair_pass / pair_pass read the flag and psum).  Every
# device draws the identical RNG stream and sees identical psum-reduced
# scalars, so the replicated chains stay in lockstep; communication is a
# handful of scalars per MC step.  This is what spreads one HUGE system
# over several devices — per-device pass cost drops to 1/D.


def mc_supported(cfg) -> bool:
    """Static gate for the spatially-sharded MC step: the scan-path jnp
    pass surface without per-move machinery that holds whole-system
    caches outside the sharded passes.  Polarization IS supported on
    the DIRECT damped field (r3): thole.static_field_direct and
    dipole_matvec round-robin their target-row blocks across the mesh
    and reassemble with one [N,3] psum per application
    (thole._rowblock_scan), so the SCF's O(N'^2) matvec — the
    hallmark-workload bottleneck — also costs 1/D per device."""
    if cfg.polarization and (cfg.polar_ewald or cfg.polar_wolf):
        return False    # k-space / shifted fields keep the full pass
    return (not cfg.cdvdw
            and not cfg.cell_list and not cfg.rd_crystal
            and not cfg.mol_cache and not cfg.spectre
            and cfg.ensemble in ("nvt", "uvt", "npt", "nve"))


def _spatial_cfg(cfg, mesh):
    import dataclasses
    ax = mesh.axis_names[0]
    return dataclasses.replace(
        cfg, spatial_axis=(ax, int(mesh.shape[ax])))


@functools.lru_cache(maxsize=64)
def _chunk_fn(mesh, cfg, n_steps):
    from jax import shard_map
    from mpmc_tpu.mc import metropolis

    def local(state, params, thermo):
        return metropolis.run_chunk.__wrapped__(state, params, cfg,
                                                thermo, n_steps)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P()),
                             out_specs=(P(), P()), check_vma=False))


@functools.lru_cache(maxsize=64)
def _init_fn(mesh, cfg, frozen_rows):
    from jax import shard_map
    from mpmc_tpu.mc import metropolis

    def local(state, params, thermo):
        return metropolis.initialize.__wrapped__(
            state, params, cfg, thermo, frozen_rows=frozen_rows)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P()),
                             out_specs=P(), check_vma=False))


def run_chunk_spatial(state, params, cfg, thermo, n_steps, mesh):
    """``metropolis.run_chunk`` with the pair passes sharded over the
    mesh (see module note).  Caller must have checked mc_supported;
    bit-level results differ from the unsharded path only by psum
    reassociation of the pair sums."""
    if not mc_supported(cfg):
        raise ValueError("spatially-sharded MC step unsupported for "
                         "this configuration (parallel/spatial."
                         "mc_supported)")
    return _chunk_fn(mesh, _spatial_cfg(cfg, mesh), int(n_steps))(
        state, params, thermo)


def initialize_spatial(state, params, cfg, thermo, mesh, frozen_rows=0):
    """Per-corrtime full refresh with the O(N^2) pair pass row-sharded
    over the mesh (the in-loop analog of total_energy_sharded)."""
    return _init_fn(mesh, _spatial_cfg(cfg, mesh), int(frozen_rows))(
        state, params, thermo)
