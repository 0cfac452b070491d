"""Post-hoc trajectory analysis: radial distribution functions and
sorbate COM density grids from MPMC-format PQR trajectories.

The reference accumulates its sorbate population histogram during the
run (SURVEY.md §2 "Histogram", src/main/histogram.c) and visualizes it
through the OpenDX writer; this module provides the same observables
computed after the fact from ``traj.pqr``, plus g(r), which MPMC users
obtain from external tools.  The heavy loops are native C++
(native/mpmc_analyze.cpp via ctypes) with the numpy implementations
below as the cross-validated reference fallback (tests/test_analyze.py).

CLI::

    python -m mpmc_tpu.analyze rdf traj.pqr --a AR --b AR --rmax 8 \
        --bins 160 --out rdf.csv
    python -m mpmc_tpu.analyze density traj.pqr --mol H2 \
        --resolution 0.7 --out density.dx
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from mpmc_tpu.io import native, pqr
from mpmc_tpu.ops import pbc


def _frame_box(frame, box):
    if frame.box is not None:
        return np.asarray(frame.box, np.float64)
    if box is None:
        raise ValueError("frame has no CRYST cell and no box= given")
    return np.asarray(box, np.float64)


def _match(name: str, pat: str) -> bool:
    # case-insensitive: PQR names are uppercased on output while users
    # type species as given in their decks ("Ar" vs "AR")
    return pat == "*" or name.upper() == pat.upper()


def _flag_ok(flag: str, sel: str) -> bool:
    if sel in ("", "*"):
        return True
    return (flag.upper().startswith("F")) == (sel.upper() == "F")


def rdf_python(frames, name_a="*", name_b="*", flag_a="*", flag_b="*",
               box=None, rmax=10.0, nbins=200):
    """Reference g(r): ordered pairs (i in A, j in B, i != j) binned by
    minimum-image distance, normalized by the per-frame ideal-gas pair
    density — the exact contract of the native kernel."""
    hist = np.zeros(nbins, np.float64)
    dr = rmax / nbins
    norm = 0.0
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        vol = abs(np.linalg.det(b))
        sel_a = [a for a in frame.atoms
                 if _match(a.name, name_a) and _flag_ok(a.flag, flag_a)]
        sel_b = [a for a in frame.atoms
                 if _match(a.name, name_b) and _flag_ok(a.flag, flag_b)]
        overlap = sum(1 for a in sel_a
                      if _match(a.name, name_b)
                      and _flag_ok(a.flag, flag_b))
        if sel_a and sel_b:
            pa = np.stack([a.xyz for a in sel_a])
            pos_b = np.stack([a.xyz for a in sel_b])
            ia = np.array([id(a) for a in sel_a])
            ib = np.array([id(a) for a in sel_b])
            d = pa[:, None, :] - pos_b[None, :, :]
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            r = np.sqrt(np.sum(d * d, -1))
            same = ia[:, None] == ib[None, :]
            r = r[~same & (r < rmax)]
            np.add.at(hist, np.minimum((r / dr).astype(int), nbins - 1),
                      1.0)
        norm += (len(sel_a) * len(sel_b) - overlap) / vol
    edges = np.arange(nbins + 1) * dr
    vshell = 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)
    with np.errstate(invalid="ignore"):
        gr = hist / (norm * vshell) if norm > 0 else np.zeros(nbins)
    return gr


def density_python(frames, mol_name="*", flag="M", dims=(32, 32, 32),
                   box=None):
    """Reference COM density counts: mass-weighted molecule COM
    (min-image unwrapped about the first atom; centroid when massless)
    binned on a fractional grid.  Returns (grid, n_frames)."""
    nx, ny, nz = (int(d) for d in dims)
    grid = np.zeros((nx, ny, nz), np.float64)
    n_frames = 0
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        mols = {}
        for a in frame.atoms:
            if _match(a.mol_name, mol_name) and _flag_ok(a.flag, flag):
                mols.setdefault(a.mol_id, []).append(a)
        for atoms in mols.values():
            r0 = np.asarray(atoms[0].xyz, np.float64)
            d = np.stack([np.asarray(a.xyz, np.float64) - r0
                          for a in atoms])
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            m = np.array([a.mass for a in atoms])
            if m.sum() > 0:
                com = r0 + (m[:, None] * d).sum(0) / m.sum()
            else:
                com = r0 + d.mean(0)
            f = com @ binv
            f -= np.floor(f)
            idx = np.clip((f * (nx, ny, nz)).astype(int), 0,
                          (nx - 1, ny - 1, nz - 1))
            grid[idx[0], idx[1], idx[2]] += 1.0
        n_frames += 1
    return grid, n_frames


def loading_python(frames, mol_name="*", flag="M"):
    """Reference per-frame selected-molecule counts (GCMC loading
    series)."""
    out = []
    for frame in frames:
        ids = {a.mol_id for a in frame.atoms
               if _match(a.mol_name, mol_name) and _flag_ok(a.flag, flag)}
        out.append(float(len(ids)))
    return np.asarray(out)


def cluster_python(frames, mol_name="*", flag="M", rc=4.0, box=None,
                   max_size=64):
    """Reference COM cluster statistics — the exact contract of the
    native kernel (traj_cluster): per frame, molecules whose COM
    min-image distance is < rc are merged into connected components
    (union-find); returns (series [n_frames, 3] = cluster count / mean
    size / largest-cluster fraction, pooled size histogram [max_size],
    cluster size s in bin min(s, max_size) - 1).  Sorbate aggregation
    diagnostics: pore-filling shows up as the largest-cluster fraction
    climbing toward 1 along an isotherm."""
    series = []
    hist = np.zeros(int(max_size))
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        mols = {}
        for a in frame.atoms:
            if _match(a.mol_name, mol_name) and _flag_ok(a.flag, flag):
                mols.setdefault(a.mol_id, []).append(a)
        coms = []
        for mid in sorted(mols):
            atoms = mols[mid]
            r0 = np.asarray(atoms[0].xyz, np.float64)
            d = np.stack([np.asarray(a.xyz, np.float64) - r0
                          for a in atoms])
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            m = np.array([a.mass for a in atoms])
            coms.append(r0 + (m[:, None] * d).sum(0) / m.sum()
                        if m.sum() > 0 else r0 + d.mean(0))
        n_m = len(coms)
        if n_m == 0:
            series.append((0.0, 0.0, 0.0))
            continue
        p = np.stack(coms)
        d = p[:, None, :] - p[None, :, :]
        fr = d @ binv
        fr -= np.round(fr)
        d = fr @ b
        adj = (d * d).sum(-1) < rc * rc
        parent = list(range(n_m))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in range(n_m):
            for j in range(i + 1, n_m):
                if adj[i, j]:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[ri] = rj
        sizes = {}
        for i in range(n_m):
            r = find(i)
            sizes[r] = sizes.get(r, 0) + 1
        sl = list(sizes.values())
        for s in sl:
            hist[min(s, int(max_size)) - 1] += 1
        series.append((float(len(sl)), n_m / len(sl), max(sl) / n_m))
    return np.asarray(series, np.float64), hist


def msd_python(frames, mol_name="*", flag="M", box=None, max_lag=0):
    """Reference mean-square COM displacement vs frame lag — the exact
    contract of the native kernel: per-molecule COM series unwrapped by
    min-image increments, segments closed on disappearance (GCMC), all
    time origins, counts returned alongside."""
    if max_lag <= 0:
        max_lag = max(len(frames) - 1, 1)
    segments, open_segs = [], {}
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        mols = {}
        for a in frame.atoms:
            if _match(a.mol_name, mol_name) and _flag_ok(a.flag, flag):
                mols.setdefault(a.mol_id, []).append(a)
        for mid in [m for m in open_segs if m not in mols]:
            segments.append(open_segs.pop(mid)[0])
        for mid, atoms in mols.items():
            r0 = np.asarray(atoms[0].xyz, np.float64)
            d = np.stack([np.asarray(a.xyz, np.float64) - r0
                          for a in atoms])
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            m = np.array([a.mass for a in atoms])
            com = (r0 + (m[:, None] * d).sum(0) / m.sum()
                   if m.sum() > 0 else r0 + d.mean(0))
            if mid not in open_segs:
                open_segs[mid] = ([com], com)
            else:
                series, last = open_segs[mid]
                step = (com - last) @ binv
                step -= np.round(step)
                series.append(series[-1] + step @ b)
                open_segs[mid] = (series, com)
    segments.extend(s[0] for s in open_segs.values())
    msd = np.zeros(max_lag + 1)
    cnt = np.zeros(max_lag + 1, np.int64)
    for seg in segments:
        u = np.stack(seg)
        for t in range(1, min(max_lag, len(u) - 1) + 1):
            d = u[t:] - u[:-t]
            msd[t] += float(np.sum(d * d))
            cnt[t] += d.shape[0]
    with np.errstate(invalid="ignore"):
        msd[1:] = np.where(cnt[1:] > 0, msd[1:] / np.maximum(cnt[1:], 1),
                           0.0)
    return msd, cnt


def orient_python(frames, mol_name="*", flag="M", axis_name="*",
                  box=None, max_lag=0):
    """Reference orientational autocorrelation — the exact contract of
    the native kernel (traj_orient): per selected molecule the axis is
    the normalized min-image vector between the first two atoms whose
    name matches ``axis_name``; segments close on disappearance (GCMC);
    all time origins.  Returns (c1 [L+1], c2 [L+1], counts [L+1])."""
    if max_lag <= 0:
        max_lag = max(len(frames) - 1, 1)
    segments, open_segs = [], {}
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        mols = {}
        for a in frame.atoms:
            if _match(a.mol_name, mol_name) and _flag_ok(a.flag, flag):
                mols.setdefault(a.mol_id, []).append(a)
        axes = {}
        for mid, atoms in mols.items():
            pick = [a for a in atoms if _match(a.name, axis_name)][:2]
            if len(pick) < 2:
                continue
            d = np.asarray(pick[1].xyz, np.float64) - np.asarray(
                pick[0].xyz, np.float64)
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            n = np.linalg.norm(d)
            if n > 0:
                axes[mid] = d / n
        for mid in [m for m in open_segs if m not in axes]:
            segments.append(open_segs.pop(mid))
        for mid, u in axes.items():
            open_segs.setdefault(mid, []).append(u)
    segments.extend(open_segs.values())
    c1 = np.zeros(max_lag + 1)
    c2 = np.zeros(max_lag + 1)
    cnt = np.zeros(max_lag + 1, np.int64)
    for seg in segments:
        u = np.stack(seg)
        for t in range(0, min(max_lag, len(u) - 1) + 1):
            dot = np.sum(u[t:] * u[:len(u) - t], axis=1)
            c1[t] += float(dot.sum())
            c2[t] += float(np.sum(1.5 * dot * dot - 0.5))
            cnt[t] += dot.shape[0]
    nz = cnt > 0
    c1[nz] /= cnt[nz]
    c2[nz] /= cnt[nz]
    return c1, c2, cnt


def sq_python(frames, q, name="*", flag="*", box=None, dr_bin=0.005):
    """Reference Debye S(q) — the exact contract of the native kernel
    (traj_sq): min-image pair distances binned at dr_bin (bin-center
    sinc evaluation), each frame's histogram weighted by 2/N_f, frames
    averaged evenly."""
    q = np.asarray(q, np.float64).reshape(-1)
    if np.any(q <= 0):
        raise ValueError("q values must be > 0")
    hist = np.zeros(0)
    n_frames = 0
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        sel = [a for a in frame.atoms
               if _match(a.name, name) and _flag_ok(a.flag, flag)]
        n_frames += 1
        if len(sel) < 2:
            continue
        p = np.stack([a.xyz for a in sel])
        d = p[:, None, :] - p[None, :, :]
        fr = d @ binv
        fr -= np.round(fr)
        d = fr @ b
        r = np.sqrt(np.sum(d * d, -1))
        iu = np.triu_indices(len(sel), k=1)
        bins = (r[iu] / dr_bin).astype(np.int64)
        if bins.size and bins.max() >= hist.size:
            hist = np.concatenate(
                [hist, np.zeros(bins.max() + 1 - hist.size)])
        np.add.at(hist, bins, 2.0 / len(sel))
    r_c = (np.arange(hist.size) + 0.5) * dr_bin
    x = q[:, None] * r_c[None, :]
    s = (hist[None, :] * np.sin(x) / x).sum(axis=1)
    return (1.0 + s / max(n_frames, 1)
            if n_frames > 0 else np.ones_like(q)), n_frames


def widom_python(frames, eps, sig, temperature, frac_pos, box=None,
                 rc=10.0):
    """Reference Widom LJ test-particle insertion — the exact contract
    of the native kernel (native/mpmc_analyze.cpp::traj_widom): a
    single-site LJ ghost LB-mixed against each frame atom's eps/sig,
    inserted at the given fractional points (reused every frame),
    minimum-image within ``rc``.  Returns (mean exp(-bU),
    mean U exp(-bU), n_frames), frames averaged evenly."""
    beta = 1.0 / float(temperature)
    fp = np.asarray(frac_pos, np.float64)
    sum_e = sum_ue = 0.0
    n_frames = 0
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        sel = [a for a in frame.atoms if a.eps > 0.0]
        p = fp @ b
        if sel:
            pa = np.stack([a.xyz for a in sel])
            d = p[:, None, :] - pa[None, :, :]
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            r2 = np.sum(d * d, -1)
            ok = r2 < rc * rc
            r2 = np.maximum(r2, 1e-12)
            s = 0.5 * (sig + np.array([a.sig for a in sel]))[None, :]
            e = np.sqrt(eps * np.array([a.eps for a in sel]))[None, :]
            s6 = (s * s / r2) ** 3
            u = np.sum(np.where(ok, 4.0 * e * s6 * (s6 - 1.0), 0.0), -1)
        else:
            u = np.zeros(len(fp))
        w = np.exp(-beta * u)
        sum_e += float(w.mean())
        sum_ue += float((u * w).mean())
        n_frames += 1
    n = max(n_frames, 1)
    return sum_e / n, sum_ue / n, n_frames


def _quat_rotate(q, v):
    """Rotate rows of v [S,3] by unit quaternion q (w,x,y,z) — the
    exact v + w*t + qv x t, t = 2 qv x v formula of the native kernel."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    qv = q[1:]
    t = 2.0 * np.cross(qv, v)
    return v + q[0] * t + np.cross(qv, t)


def widom_mol_python(frames, site_xyz, site_eps, site_sig, site_q,
                     temperature, posquat, box=None, rc=10.0):
    """Reference rigid multi-site Widom insertion — the exact contract
    of the native kernel (traj_widom_mol): template sites rotated by the
    trial quaternion, COM at the trial fractional point, LJ
    (LB-mixed, both eps > 0) + cutoff Coulomb (both charges nonzero)
    within rc, minimum image.  Returns (mean exp(-bU), mean U exp(-bU),
    n_frames)."""
    from mpmc_tpu.constants import KE
    beta = 1.0 / float(temperature)
    xyz = np.asarray(site_xyz, np.float64).reshape(-1, 3)
    eps_s = np.asarray(site_eps, np.float64).ravel()
    sig_s = np.asarray(site_sig, np.float64).ravel()
    q_s = np.asarray(site_q, np.float64).ravel()
    pq = np.asarray(posquat, np.float64)
    sum_e = sum_ue = 0.0
    n_frames = 0
    for frame in frames:
        b = _frame_box(frame, box)
        binv = np.linalg.inv(b)
        sel = [a for a in frame.atoms if a.eps > 0.0 or a.charge != 0.0]
        fe = fue = 0.0
        for row in pq:
            p = row[:3] @ b
            rot = _quat_rotate(row[3:], xyz) + p
            u = 0.0
            if sel:
                pa = np.stack([a.xyz for a in sel])
                a_eps = np.array([a.eps for a in sel])
                a_sig = np.array([a.sig for a in sel])
                a_q = np.array([a.charge for a in sel])
                d = rot[:, None, :] - pa[None, :, :]
                fr = d @ binv
                fr -= np.round(fr)
                d = fr @ b
                r2 = np.maximum(np.sum(d * d, -1), 1e-12)
                ok = r2 < rc * rc
                lj_ok = ok & (a_eps[None, :] > 0) & (eps_s[:, None] > 0)
                s_mix = 0.5 * (sig_s[:, None] + a_sig[None, :])
                s6 = (s_mix * s_mix / r2) ** 3
                e_mix = np.sqrt(eps_s[:, None] * a_eps[None, :])
                u += float(np.sum(np.where(
                    lj_ok, 4.0 * e_mix * s6 * (s6 - 1.0), 0.0)))
                es_ok = ok & (a_q[None, :] != 0) & (q_s[:, None] != 0)
                u += float(np.sum(np.where(
                    es_ok, KE * q_s[:, None] * a_q[None, :]
                    / np.sqrt(r2), 0.0)))
            w = np.exp(-beta * u)
            fe += w
            fue += u * w
        sum_e += fe / len(pq)
        sum_ue += fue / len(pq)
        n_frames += 1
    n = max(n_frames, 1)
    return sum_e / n, sum_ue / n, n_frames


def _half_min_width(b):
    """Half the minimum perpendicular cell width of a 3x3 row basis —
    the min-image validity cap (matches the native half_min_width)."""
    b = np.asarray(b, np.float64)
    vol = abs(np.linalg.det(b))
    widths = [vol / np.linalg.norm(np.cross(b[(k + 1) % 3],
                                            b[(k + 2) % 3]))
              for k in range(3)]
    return 0.5 * min(widths)


def _pore_selection(frame, name, flag):
    """(positions [na,3], radii [na]) of the sig>0 hard spheres the
    geometry analyzers see (radius = LJ sigma / 2)."""
    sel = [a for a in frame.atoms
           if a.sig > 0.0 and _match(a.name, name)
           and _flag_ok(a.flag, flag)]
    if not sel:
        return np.zeros((0, 3)), np.zeros(0)
    return (np.stack([np.asarray(a.xyz, np.float64) for a in sel]),
            np.array([0.5 * a.sig for a in sel]))


def _d_surf(p, pa, rad, b, binv, cap):
    """Surface distance of points p [n,3] to the hard spheres
    (pa, rad), minimum image, clamped above by cap."""
    if len(pa) == 0:
        return np.full(len(p), cap)
    d = p[:, None, :] - pa[None, :, :]
    fr = d @ binv
    fr -= np.round(fr)
    d = fr @ b
    r = np.sqrt(np.sum(d * d, -1)) - rad[None, :]
    return np.minimum(r.min(axis=1), cap)


def pore_python(frames, name="*", flag="F", frac_pts=None,
                frac_ctr=None, box=None):
    """Reference geometric pore sampling — the exact contract of the
    native kernel (native/mpmc_analyze.cpp::traj_pore) on the FIRST
    frame: per sample point, the surface distance d_surf (min over
    sig>0 selected atoms of min-image distance minus sigma/2, clamped
    to half the minimum perpendicular cell width) and the Gelb-Gubbins
    pore radius (largest d_surf(c) over candidate centers whose sphere
    covers the point; >= d_surf always).  Returns (d_surf, r_pore)."""
    frame = next(iter(frames))
    b = _frame_box(frame, box)
    binv = np.linalg.inv(b)
    cap = _half_min_width(b)
    pa, rad = _pore_selection(frame, name, flag)
    p = np.asarray(frac_pts, np.float64) @ b
    dp = _d_surf(p, pa, rad, b, binv, cap)
    r_out = dp.copy()
    if frac_ctr is not None and len(frac_ctr):
        c = np.asarray(frac_ctr, np.float64) @ b
        cd = _d_surf(c, pa, rad, b, binv, cap)
        # chunk the [n_points, n_centers] coverage matrix
        for k0 in range(0, len(p), 1024):
            pk = p[k0:k0 + 1024]
            d = pk[:, None, :] - c[None, :, :]
            fr = d @ binv
            fr -= np.round(fr)
            d = fr @ b
            covered = np.sum(d * d, -1) <= cd[None, :] ** 2
            best = np.where(covered, cd[None, :], -np.inf).max(axis=1)
            blk = r_out[k0:k0 + 1024]
            r_out[k0:k0 + 1024] = np.where((blk >= 0.0) & (best > blk),
                                           best, blk)
    return dp, r_out


def asa_python(frames, name="*", flag="F", probe_sigma=0.0,
               unit_pts=None, box=None):
    """Reference Shrake-Rupley accessible surface area — the exact
    contract of the native kernel (traj_asa) on the FIRST frame: each
    selected sig>0 atom carries radius (sigma + probe_sigma)/2; test
    points on its inflated sphere are accessible iff inside no OTHER
    selected atom's inflated sphere (minimum image).  Returns
    (area [A^2], cell volume [A^3], selected mass sum [amu])."""
    frame = next(iter(frames))
    b = _frame_box(frame, box)
    binv = np.linalg.inv(b)
    mass = sum(a.mass for a in frame.atoms
               if _match(a.name, name) and _flag_ok(a.flag, flag))
    pa, rad = _pore_selection(frame, name, flag)
    R = rad + 0.5 * probe_sigma
    u = np.asarray(unit_pts, np.float64)
    area = 0.0
    for i in range(len(pa)):
        p = pa[i] + R[i] * u
        d = p[:, None, :] - pa[None, :, :]
        fr = d @ binv
        fr -= np.round(fr)
        d = fr @ b
        r2 = np.sum(d * d, -1)
        blocked = r2 < R[None, :] ** 2
        blocked[:, i] = False
        acc = float(np.mean(~blocked.any(axis=1)))
        area += 4.0 * np.pi * R[i] ** 2 * acc
    vol = abs(np.linalg.det(b))
    return area, vol, mass


def pore(path, name="*", flag="F", probe_sigma=0.0, n_points=20000,
         n_centers=2000, seed=0, box=None, use_native=True,
         frac_pts=None, frac_ctr=None, nbins=60):
    """Geometric pore characterization of a structure (first frame) —
    native when available.  Atoms are hard spheres of radius sigma/2;
    the probe radius is probe_sigma/2.  Returns a dict with
    ``void_fraction`` (fraction of cell volume where the probe CENTER
    fits: d_surf >= r_probe), ``coverable_fraction`` (fraction inside
    some sphere of radius >= r_probe: the Gelb-Gubbins r_pore >=
    r_probe), the pore-size distribution (``psd_r`` bin centers,
    ``psd`` density over probe-coverable void, ``psd_cumulative``
    fraction of void coverable by radius >= r), ``d_max`` (largest
    surface distance seen — the largest included-sphere radius
    estimate), ``cap`` and ``volume``."""
    out = None
    if use_native and frac_pts is None and frac_ctr is None:
        out = native.traj_pore(path, name, flag, n_points=n_points,
                               n_centers=n_centers, seed=seed, box=box)
    if out is None:
        rng = np.random.default_rng(seed)
        if frac_pts is None:
            frac_pts = rng.uniform(0.0, 1.0, (int(n_points), 3))
        if frac_ctr is None:
            frac_ctr = rng.uniform(0.0, 1.0, (int(n_centers), 3))
        out = pore_python(pqr.read_frames(path), name, flag,
                          frac_pts=frac_pts, frac_ctr=frac_ctr, box=box)
    d, r = out
    frame0 = pqr.read_first_frame(path)
    b = _frame_box(frame0, box)
    cap = _half_min_width(b)
    r_probe = 0.5 * float(probe_sigma)
    void = float(np.mean(d >= r_probe))
    coverable = float(np.mean(r >= r_probe))
    rv = r[r >= r_probe]
    hist, edges = np.histogram(rv, bins=nbins,
                               range=(r_probe, max(cap, r_probe + 1e-9)),
                               density=rv.size > 0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    cum = (np.array([np.mean(rv >= e) for e in edges[:-1]])
           if rv.size else np.zeros(nbins))
    return {"void_fraction": void, "coverable_fraction": coverable,
            "psd_r": centers, "psd": hist, "psd_cumulative": cum,
            "d_max": float(d.max()) if len(d) else 0.0,
            "cap": cap, "volume": float(abs(np.linalg.det(b))),
            "n_points": int(len(d))}


def asa(path, name="*", flag="F", probe_sigma=0.0, n_sphere=512,
        seed=0, box=None, use_native=True, unit_pts=None):
    """Accessible surface area of a structure (first frame) — native
    when available.  Returns a dict with ``area_A2``, ``area_m2_g``
    (per selected mass), ``area_m2_cm3`` (per cell volume),
    ``volume_A3`` and ``mass_amu``."""
    out = None
    if use_native and unit_pts is None:
        out = native.traj_asa(path, name, flag,
                              probe_sigma=probe_sigma,
                              n_sphere=n_sphere, seed=seed, box=box)
    if out is None:
        if unit_pts is None:
            v = np.random.default_rng(seed).normal(
                size=(int(n_sphere), 3))
            unit_pts = v / np.linalg.norm(v, axis=1, keepdims=True)
        out = asa_python(pqr.read_frames(path), name, flag,
                         probe_sigma=probe_sigma, unit_pts=unit_pts,
                         box=box)
    area, vol, mass = out
    # amu -> g: 1.66053906660e-24; A^2 -> m^2: 1e-20; A^3 -> cm^3: 1e-24
    m2_g = area * 1e-20 / (mass * 1.66053906660e-24) if mass > 0 \
        else float("nan")
    m2_cm3 = area / vol * 1e4 if vol > 0 else float("nan")
    return {"area_A2": area, "area_m2_g": m2_g, "area_m2_cm3": m2_cm3,
            "volume_A3": vol, "mass_amu": mass}


def template_sites(insert_pqr):
    """(site_xyz [S,3] about the mass-weighted COM, eps, sig, charge)
    from an insertion-template PQR (the GCMC insert_input deck)."""
    frame = pqr.read_first_frame(insert_pqr)
    if not frame.atoms:
        raise ValueError(f"{insert_pqr}: empty template")
    xyz = np.stack([np.asarray(a.xyz, np.float64) for a in frame.atoms])
    m = np.array([a.mass for a in frame.atoms])
    com = (m[:, None] * xyz).sum(0) / m.sum() if m.sum() > 0 \
        else xyz.mean(0)
    return (xyz - com,
            np.array([a.eps for a in frame.atoms]),
            np.array([a.sig for a in frame.atoms]),
            np.array([a.charge for a in frame.atoms]))


def _widom_post(out, path, temperature, box):
    """Shared Widom post-processing: (mean e, mean U e, n_frames) ->
    mu_ex / <U>_0 / Henry-coefficient dict (single-site and template
    paths report identically)."""
    e_mean, ue_mean, n_frames = out
    from mpmc_tpu.constants import ATM2K_A3
    # metadata only (framework mass + cell): never re-parse the whole
    # trajectory the compute kernel already scanned
    frame0 = pqr.read_first_frame(path)
    fw_mass = sum(a.mass for a in frame0.atoms if _flag_ok(a.flag, "F"))
    u0 = ue_mean / e_mean if e_mean > 0 else float("nan")
    mu_ex = (-temperature * float(np.log(e_mean)) if e_mean > 0
             else float("inf"))
    kh = float("nan")
    if fw_mass > 0 and e_mean > 0:
        b = _frame_box(frame0, box)
        vol = abs(np.linalg.det(b))
        # Henry's law: <N> = (f/kT) V <exp(-bU)>, f in atm
        # (ATM2K_A3: atm -> K/A^3).  K_H [mol / (kg_framework * atm)]
        # = (<N>/f / N_A) / (m_frame[amu] / N_A / 1000) — Avogadro
        # cancels: 1000 * ATM2K_A3 * V * <e> / (T * m_frame).
        kh = 1e3 * ATM2K_A3 * vol * e_mean / (temperature * fw_mass)
    return {"boltzmann": e_mean, "mu_ex": mu_ex, "u0": u0,
            "kh_mol_kg_atm": kh, "n_frames": n_frames}


def widom_mol(path, insert_pqr, temperature, n_try=2000, seed=0,
              box=None, rc=10.0, use_native=True, posquat=None):
    """Rigid multi-site Widom insertion over a trajectory, template
    from an insert_input-style PQR — native when available.  Energy =
    LB-mixed LJ + plain-cutoff Coulomb (documented approximation; the
    run-time Henry machinery is the full-Ewald path).  Returns the same
    dict as widom()."""
    sx, se, ss, sq2 = template_sites(insert_pqr)
    out = None
    if use_native and posquat is None:
        out = native.traj_widom_mol(path, sx, se, ss, sq2, temperature,
                                    n_try=n_try, seed=seed, box=box,
                                    rc=rc)
    if out is None:
        if posquat is None:
            rng = np.random.default_rng(seed)
            u = rng.uniform(0.0, 1.0, (int(n_try), 6))
            quat = np.stack([
                np.sqrt(u[:, 3]) * np.cos(2 * np.pi * u[:, 5]),
                np.sqrt(1 - u[:, 3]) * np.sin(2 * np.pi * u[:, 4]),
                np.sqrt(1 - u[:, 3]) * np.cos(2 * np.pi * u[:, 4]),
                np.sqrt(u[:, 3]) * np.sin(2 * np.pi * u[:, 5])], -1)
            posquat = np.concatenate([u[:, :3], quat], -1)
        out = widom_mol_python(pqr.read_frames(path), sx, se, ss, sq2,
                               temperature, posquat, box=box, rc=rc)
    return _widom_post(out, path, temperature, box)


def widom(path, eps, sig, temperature, n_try=2000, seed=0, box=None,
          rc=10.0, use_native=True, frac_pos=None):
    """Widom insertion over a trajectory — native when available.
    Returns a dict with the dimensionless Henry factor
    ``boltzmann`` = <exp(-U/kT)>, the excess chemical potential
    ``mu_ex`` = -kT ln<exp(-U/kT)> [K], the infinite-dilution mean
    adsorption energy ``u0`` = <U e>/<e> [K], the Henry coefficient
    ``kh_mol_kg_atm`` (per framework mass), and ``n_frames``."""
    out = None
    if use_native and frac_pos is None:
        out = native.traj_widom(path, eps, sig, temperature,
                                n_try=n_try, seed=seed, box=box, rc=rc)
    if out is None:
        if frac_pos is None:
            frac_pos = np.random.default_rng(seed).uniform(
                0.0, 1.0, (int(n_try), 3))
        out = widom_python(pqr.read_frames(path), eps, sig, temperature,
                           frac_pos, box=box, rc=rc)
    return _widom_post(out, path, temperature, box)


def loading(path, mol_name="*", flag="M", use_native=True):
    """Per-frame selected-molecule counts — native when available."""
    counts = None
    if use_native:
        counts = native.traj_loading(path, mol_name, flag)
    if counts is None:
        counts = loading_python(pqr.read_frames(path), mol_name, flag)
    return counts


def cluster(path, mol_name="*", flag="M", rc=4.0, box=None, max_size=64,
            use_native=True):
    """(series [n_frames, 3], size histogram [max_size]) of COM
    connected-component clusters — native when available."""
    res = None
    if use_native:
        res = native.traj_cluster(path, mol_name, flag, rc=rc, box=box,
                                  max_size=max_size)
    if res is None:
        res = cluster_python(pqr.read_frames(path), mol_name, flag,
                             rc=rc, box=box, max_size=max_size)
    return res


def msd(path, mol_name="*", flag="M", box=None, max_lag=0,
        use_native=True):
    """(msd [L+1], counts [L+1]) vs frame lag — native when available."""
    out = None
    if use_native:
        out = native.traj_msd(path, mol_name, flag, box=box,
                              max_lag=max_lag)
    if out is None:
        out = msd_python(pqr.read_frames(path), mol_name, flag, box=box,
                         max_lag=max_lag)
    return out


def orientation(path, mol_name="*", flag="M", axis_name="*", box=None,
                max_lag=0, use_native=True):
    """(c1, c2, counts) orientational autocorrelation vs frame lag —
    native when available."""
    out = None
    if use_native:
        out = native.traj_orient(path, mol_name, flag, axis_name,
                                 box=box, max_lag=max_lag)
    if out is None:
        out = orient_python(pqr.read_frames(path), mol_name, flag,
                            axis_name, box=box, max_lag=max_lag)
    return out


def sq(path, q, name="*", flag="*", box=None, dr_bin=0.005,
       use_native=True):
    """(S(q) [nq], n_frames) Debye structure factor — native when
    available."""
    out = None
    if use_native:
        out = native.traj_sq(path, q, name, flag, box=box, dr_bin=dr_bin)
    if out is None:
        out = sq_python(pqr.read_frames(path), q, name, flag, box=box,
                        dr_bin=dr_bin)
    return out


def qst(n_series, u_series, temperature, n_blocks=10):
    """Isosteric heat of adsorption from stored (N, U) corrtime series
    via the GCMC fluctuation formula the in-run averages use
    (utils/averages.py; SURVEY.md §2 "Averages/observables"):

        Qst = kT - (<UN> - <U><N>) / (<N^2> - <N>^2)     [K units]

    Post-hoc companion to the in-run estimate: run it over a JSONL /
    energy-CSV stream (or several concatenated reruns) with an
    equilibration skip of the caller's choice.  Error bar: jackknife
    over ``n_blocks`` contiguous blocks (the fluctuation ratio is
    nonlinear, so block-SEM of the ratio, not of the inputs).  Returns
    dict with qst, qst_sem, n_mean, n_sem (blocking), samples."""
    n = np.asarray(n_series, np.float64).ravel()
    u = np.asarray(u_series, np.float64).ravel()
    if n.size != u.size:
        raise ValueError("N and U series must be the same length")
    if n.size < 2 * n_blocks:
        raise ValueError(f"need >= {2 * n_blocks} samples for "
                         f"{n_blocks}-block jackknife")
    if float(np.var(n)) == 0.0:
        raise ValueError("var(N) = 0 — not a GCMC series (fixed N?)")

    def ratio(nn, uu):
        return ((uu * nn).mean() - uu.mean() * nn.mean()) / \
            max(float((nn * nn).mean() - nn.mean() ** 2), 1e-300)

    q_full = temperature - ratio(n, u)
    # leave-one-block-out jackknife
    edges = np.linspace(0, n.size, n_blocks + 1).astype(int)
    loo = []
    for k in range(n_blocks):
        keep = np.r_[0:edges[k], edges[k + 1]:n.size]
        loo.append(temperature - ratio(n[keep], u[keep]))
    loo = np.asarray(loo)
    q_sem = float(np.sqrt((n_blocks - 1) / n_blocks
                          * np.sum((loo - loo.mean()) ** 2)))
    _, sems, _, tau = blocking(n)
    return {"qst": float(q_full), "qst_sem": q_sem,
            "n_mean": float(n.mean()),
            "n_sem": float(sems[0] * np.sqrt(tau)),
            "samples": int(n.size)}


def qst_clausius_clapeyron(p1, q1, t1, p2, q2, t2, n_loadings=20):
    """Isosteric heat vs loading from two isotherms (Clausius-Clapeyron):

        Qst(theta) = -R * ln(P2/P1) / (1/T2 - 1/T1)   at equal loading

    the standard experimental construction, and the cross-check of the
    in-run fluctuation-formula Qst (utils/averages.py).  Each isotherm
    is interpolated in (ln P, loading); the loading grid spans the
    overlap of the two loading ranges.  Returns (loadings, qst_K) —
    Kelvin units (divide by 1e3/8.314... for kJ/mol upstream)."""
    p1 = np.asarray(p1, np.float64).ravel()
    q1 = np.asarray(q1, np.float64).ravel()
    p2 = np.asarray(p2, np.float64).ravel()
    q2 = np.asarray(q2, np.float64).ravel()
    if t1 == t2:
        raise ValueError("isotherms must differ in temperature")
    for p, q in ((p1, q1), (p2, q2)):
        if p.size != q.size or p.size < 2:
            raise ValueError("each isotherm needs >= 2 (P, loading) "
                             "points")
        if np.any(p <= 0):
            raise ValueError("pressures must be > 0")
        if np.any(np.diff(q) <= 0):
            raise ValueError("loadings must be strictly increasing "
                             "with P (sort / de-noise first)")
    lo = max(q1.min(), q2.min())
    hi = min(q1.max(), q2.max())
    if not hi > lo:
        raise ValueError("isotherm loading ranges do not overlap")
    theta = np.linspace(lo, hi, int(n_loadings))
    lnp1 = np.interp(theta, q1, np.log(p1))
    lnp2 = np.interp(theta, q2, np.log(p2))
    qst_k = -(lnp2 - lnp1) / (1.0 / t2 - 1.0 / t1)
    return theta, qst_k


_ISO_MODELS = {
    # loading(P; params) — P in the user's pressure unit, params > 0
    "langmuir": (("qm", "k"),
                 lambda p, qm, k: qm * k * p / (1.0 + k * p)),
    "dsl": (("qm1", "k1", "qm2", "k2"),
            lambda p, qm1, k1, qm2, k2: qm1 * k1 * p / (1.0 + k1 * p)
            + qm2 * k2 * p / (1.0 + k2 * p)),
    "toth": (("qm", "k", "t"),
             lambda p, qm, k, t: qm * k * p
             / (1.0 + (k * p) ** t) ** (1.0 / t)),
}


def isotherm_fit(pressures, loadings, model="langmuir", sem=None):
    """Fit an adsorption-isotherm model to (P, loading) points.

    Models: langmuir  q = qm K P / (1 + K P)
            dsl       two-site Langmuir
            toth      q = qm K P / (1 + (K P)^t)^(1/t)
    All parameters are constrained positive (log-space optimization);
    ``sem`` (per-point 1-sigma) weights the residuals when given.
    Returns dict with params, rmse, henry (low-pressure slope dq/dP),
    model.  Campaign output (campaign.py) feeds straight in."""
    from scipy.optimize import least_squares
    p = np.asarray(pressures, np.float64).ravel()
    y = np.asarray(loadings, np.float64).ravel()
    if p.size != y.size or p.size < 2:
        raise ValueError("need matching P/loading arrays, >= 2 points")
    if np.any(p <= 0):
        raise ValueError("pressures must be > 0")
    if model not in _ISO_MODELS:
        raise ValueError(f"unknown model {model!r}; "
                         f"choose from {sorted(_ISO_MODELS)}")
    names, fn = _ISO_MODELS[model]
    if p.size < len(names):
        raise ValueError(f"{model} needs >= {len(names)} points")
    w = np.ones_like(y)
    if sem is not None:
        s = np.asarray(sem, np.float64).ravel()
        if not np.all(np.isfinite(s)) or np.any(s <= 0):
            raise ValueError(
                "sem column has non-finite or non-positive entries "
                "(single-chain campaigns write inf) — fix them or fit "
                "unweighted (omit the sem column)")
        w = 1.0 / np.maximum(s, 1e-12)
    qm0 = max(float(y.max()) * 1.5, 1e-6)
    k0 = 1.0 / float(np.median(p))
    starts = {"langmuir": [qm0, k0], "toth": [qm0, k0, 0.7],
              "dsl": [qm0 * 0.6, k0 * 3.0, qm0 * 0.6, k0 / 3.0]}[model]

    def resid(logx):
        return w * (fn(p, *np.exp(logx)) - y)

    fit = least_squares(resid, np.log(np.asarray(starts)), method="lm",
                        max_nfev=20000)
    prm = np.exp(fit.x)
    pred = fn(p, *prm)
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    henry = prm[0] * prm[1]
    if model == "dsl":
        henry += prm[2] * prm[3]
    return {"model": model, "params": dict(zip(names, prm.tolist())),
            "rmse": rmse, "henry": float(henry),
            "converged": bool(fit.success)}


def _spreading_pressure(model, params, p):
    """Reduced spreading pressure pi(p) = integral_0^p q(p')/p' dp' for
    a fitted isotherm model (closed form where it exists)."""
    if p <= 0:
        return 0.0
    if model == "langmuir":
        return params["qm"] * np.log1p(params["k"] * p)
    if model == "dsl":
        return (params["qm1"] * np.log1p(params["k1"] * p)
                + params["qm2"] * np.log1p(params["k2"] * p))
    from scipy.integrate import quad
    names, fn = _ISO_MODELS[model]
    prm = [params[k] for k in names]
    # q(p)/p is finite at 0 (Henry law) — quad handles the endpoint
    val, _ = quad(lambda x: fn(x, *prm) / x, 0.0, p, limit=200)
    return float(val)


def iast_binary(fit1, fit2, y1, p_total):
    """Binary IAST (Myers & Prausnitz 1965): predict mixture adsorption
    from two fitted PURE-component isotherms (isotherm_fit outputs) at
    gas-phase mole fraction ``y1`` (component 1) and total pressure
    ``p_total``.

    Solves pi_1(P y1 / x1) = pi_2(P y2 / x2) for the adsorbed-phase
    fraction x1 by bisection, then 1/q_T = x1/q1⁰ + x2/q2⁰.  Returns
    dict with x1, loadings q1/q2/q_total, and the selectivity
    S_12 = (x1/x2)/(y1/y2).  Validation anchor: two Langmuir isotherms
    with EQUAL qm reproduce the extended-Langmuir closed form exactly
    (tests/test_analyze.py)."""
    if not 0.0 < y1 < 1.0:
        raise ValueError("y1 must be in (0, 1)")
    if p_total <= 0:
        raise ValueError("p_total must be > 0")
    y2 = 1.0 - y1
    m1, pr1 = fit1["model"], fit1["params"]
    m2, pr2 = fit2["model"], fit2["params"]
    names1, fn1 = _ISO_MODELS[m1]
    names2, fn2 = _ISO_MODELS[m2]

    def diff(x1):
        # pi_1 at p1^0 = P y1/x1 minus pi_2 at p2^0 = P y2/(1-x1)
        return (_spreading_pressure(m1, pr1, p_total * y1 / x1)
                - _spreading_pressure(m2, pr2,
                                      p_total * y2 / (1.0 - x1)))

    # diff is monotone decreasing in x1: bisect on (0, 1)
    lo, hi = 1e-12, 1.0 - 1e-12
    flo, fhi = diff(lo), diff(hi)
    if not (flo > 0 > fhi or flo < 0 < fhi):
        raise ValueError("IAST bisection bracket failed (degenerate "
                         "isotherms?)")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        fm = diff(mid)
        if (fm > 0) == (flo > 0):
            lo, flo = mid, fm
        else:
            hi, fhi = mid, fm
    x1 = 0.5 * (lo + hi)
    x2 = 1.0 - x1
    q1_0 = fn1(p_total * y1 / x1, *[pr1[k] for k in names1])
    q2_0 = fn2(p_total * y2 / x2, *[pr2[k] for k in names2])
    q_t = 1.0 / (x1 / q1_0 + x2 / q2_0)
    return {"x1": float(x1), "q1": float(x1 * q_t),
            "q2": float(x2 * q_t), "q_total": float(q_t),
            "selectivity": float((x1 / x2) / (y1 / y2))}


def rdf(path, name_a="*", name_b="*", flag_a="*", flag_b="*", box=None,
        rmax=10.0, nbins=200, use_native=True):
    """(r_centers, g) from a trajectory file — native when available."""
    gr = None
    if use_native:
        gr = native.traj_rdf(path, name_a, name_b, flag_a, flag_b,
                             box=box, rmax=rmax, nbins=nbins)
    if gr is None:
        gr = rdf_python(pqr.read_frames(path), name_a, name_b, flag_a,
                        flag_b, box=box, rmax=rmax, nbins=nbins)
    r = (np.arange(nbins) + 0.5) * (rmax / nbins)
    return r, gr


def density(path, mol_name="*", flag="M", resolution=0.7, box=None,
            use_native=True):
    """Per-frame-averaged COM density grid; returns (grid, dims, box).
    ``box`` (3x3) is required when frames lack CRYST records; grid dims
    follow PopulationHistogram (ceil(|cell vector| / resolution))."""
    if box is None:
        frames = pqr.read_frames(path)
        if not frames or frames[0].box is None:
            raise ValueError("no CRYST cell in trajectory; pass box=")
        box = frames[0].box
    box = np.asarray(box, np.float64)
    lengths = np.linalg.norm(box, axis=1)
    dims = tuple(int(d) for d in
                 np.maximum(np.ceil(lengths / resolution), 1))
    out = None
    if use_native:
        out = native.traj_density(path, mol_name, flag, dims, box=box)
    if out is None:
        out = density_python(pqr.read_frames(path), mol_name, flag,
                             dims, box=box)
    grid, n_frames = out
    return grid / max(n_frames, 1), dims, box


def blocking(series):
    """Flyvbjerg-Petersen blocking analysis of a scalar MC series.

    Returns (block_sizes, sem, sem_err, tau_int): the standard error of
    the mean estimated at doubling block sizes (with its own one-sigma
    uncertainty sem/sqrt(2(n_blocks-1))), and the integrated
    autocorrelation estimate tau_int = (sem_inf/sem_1)^2 read off at
    the largest block level that still has >= 32 blocks (falling back
    to >= 8 blocks for short series — noisier, but never the silent
    tau = 1 of the raw level).  The
    in-run averages report block-SEM at the corrtime cadence
    (utils/averages.py); this is the post-hoc tool for choosing that
    cadence and for error bars on replayed/stored series."""
    x = np.asarray(series, np.float64).ravel()
    if x.size < 4:
        raise ValueError("blocking needs >= 4 samples")
    sizes, sems, errs = [], [], []
    block = 1
    while x.size >= 4:
        n = x.size
        var = x.var(ddof=1)
        sem = float(np.sqrt(var / n))
        sizes.append(block)
        sems.append(sem)
        errs.append(sem / np.sqrt(2.0 * (n - 1)))
        x = 0.5 * (x[0:2 * (n // 2):2] + x[1:2 * (n // 2):2])
        block *= 2
    sems = np.asarray(sems)
    # plateau read-off at the largest level that still has >= 32
    # blocks: higher levels converge no further but their SEM noise
    # (1/sqrt(2(n_blocks-1))) swamps the estimate
    n0 = len(np.asarray(series).ravel())
    eligible = ([i for i, b in enumerate(sizes) if n0 // b >= 32]
                or [i for i, b in enumerate(sizes) if n0 // b >= 8]
                or [len(sizes) - 1])
    plateau = max(eligible)
    tau = float((sems[plateau] / sems[0]) ** 2) if sems[0] > 0 else 1.0
    return (np.asarray(sizes), sems, np.asarray(errs), tau)


def _logsumexp(a, axis=None):
    """log(sum(exp(a))) along axis, max-shifted for stability."""
    a = np.asarray(a, np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None \
        else float(out.reshape(()))


def mbar_fit(betas, u_by_state, tol=1e-10, max_iter=50000):
    """Multistate Bennett acceptance ratio over a temperature ladder
    (Shirts & Chodera 2008): self-consistent dimensionless free
    energies f_k of K canonical states at inverse temperatures
    ``betas`` [K] from potential-energy samples ``u_by_state`` (list of
    K arrays, u in K — the Boltzmann factor is exp(-beta*u)).

    Assumes the POTENTIAL is temperature-independent (not valid for
    Feynman-Hibbs / Feynman-Kleinert ladders, whose effective U depends
    on T) and canonical sampling at each state (an NVT parallel-
    tempering ladder qualifies: swaps preserve each state's canonical
    distribution).  Returns a dict consumed by mbar_reweight: the
    converged f (f[0] = 0), the concatenated samples, and the MBAR
    log-denominator per sample."""
    betas = np.asarray(betas, np.float64).ravel()
    u_list = [np.asarray(u, np.float64).ravel() for u in u_by_state]
    if len(u_list) != betas.size:
        raise ValueError("betas and u_by_state lengths differ")
    if any(len(u) == 0 for u in u_list):
        raise ValueError("every state needs at least one sample")
    n_k = np.array([len(u) for u in u_list], np.float64)
    u_all = np.concatenate(u_list)
    bu = betas[:, None] * u_all[None, :]          # [K, Ntot]
    f, log_denom, converged, its = _mbar_core(bu, n_k, tol=tol,
                                              max_iter=max_iter)
    return {"betas": betas, "f": f, "u_all": u_all,
            "log_denom": log_denom, "n_k": n_k,
            "converged": converged, "iterations": its}


def _mbar_core(u_kn, n_k, tol=1e-10, max_iter=50000):
    """Self-consistent MBAR solve over an arbitrary reduced-potential
    matrix ``u_kn`` [K states x Ntot pooled samples] (Shirts & Chodera
    2008 eq. 11-13): the state definition lives entirely in u_kn, so
    the same core serves canonical ladders (u = beta_k U) and
    grand-canonical ones (u = beta U - sum_s N_s ln(beta f_ks V)).
    Returns (f [K] with f[0]=0, log_denom [Ntot], converged, iters)."""
    u_kn = np.asarray(u_kn, np.float64)
    n_k = np.asarray(n_k, np.float64).ravel()
    log_n = np.log(n_k)
    f = np.zeros(u_kn.shape[0])
    delta = np.inf
    for it in range(max_iter):
        log_denom = _logsumexp((log_n + f)[:, None] - u_kn, axis=0)
        f_new = -_logsumexp(-u_kn - log_denom[None, :], axis=1)
        f_new = f_new - f_new[0]
        delta = float(np.max(np.abs(f_new - f)))
        f = f_new
        if delta < tol:
            break
    log_denom = _logsumexp((log_n + f)[:, None] - u_kn, axis=0)
    return f, log_denom, delta < tol, it + 1


def mbar_reweight(fit, beta, a_vals=None):
    """Reweight MBAR samples to inverse temperature ``beta``: returns
    {u_mean, u_var, a_mean (when ``a_vals`` [Ntot] given, aligned with
    fit['u_all']), ess (Kish effective sample size), logZ (relative
    dimensionless free energy -f(beta) up to the fit's constant)}."""
    u = fit["u_all"]
    logw = -float(beta) * u - fit["log_denom"]
    lz = _logsumexp(logw)
    w = np.exp(logw - lz)
    u_mean = float(np.sum(w * u))
    out = {"u_mean": u_mean,
           "u_var": float(np.sum(w * (u - u_mean) ** 2)),
           "ess": float(1.0 / np.sum(w * w)), "logZ": lz}
    if a_vals is not None:
        out["a_mean"] = float(np.sum(w * np.asarray(a_vals,
                                                    np.float64).ravel()))
    return out


def _read_ladder(path):
    """(temps [B,K], energy [B,K], n [B,K], fug [B,K] or None) from the
    PT driver's per-block ladder records in a JSONL stream
    (io/output.py::log_ladder).  fug is present only for fixed-T
    fugacity-ladder runs (pt_fugacity)."""
    import json
    temps, us, ns, fs = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "pt_temps" not in rec:
                continue
            temps.append(rec["pt_temps"])
            us.append(rec["pt_energy"])
            ns.append(rec.get("pt_N", [0.0] * len(rec["pt_temps"])))
            if "pt_fug" in rec:
                fs.append(rec["pt_fug"])
    if not temps:
        raise ValueError(f"no pt_temps ladder records in {path} "
                         "(run the PT driver with --jsonl)")
    if fs and len(fs) != len(temps):
        raise ValueError(f"{path}: only some ladder records carry "
                         "pt_fug — mixed-run stream?")
    return (np.asarray(temps, np.float64), np.asarray(us, np.float64),
            np.asarray(ns, np.float64),
            np.asarray(fs, np.float64) if fs else None)


def pt_mbar(jsonl_path, t_grid=None, skip=0.0, n_t=50):
    """Continuous-temperature observable curves from ONE parallel-
    tempering run via MBAR: reads the per-block ladder records
    (pt_temps/pt_energy/pt_N) from the run's JSONL stream, groups the
    samples by the temperature they were recorded at (swaps permute the
    ladder but preserve its values), fits the K-state MBAR free
    energies, and reweights to ``t_grid`` (default: n_t points spanning
    the ladder).  Returns {t_grid, u_mean, cv_kb (fluctuation formula
    (<U^2>-<U>^2)/T^2 in k_B units), n_mean, ess, ladder_t, delta_f
    (dimensionless free energies vs the coldest state), converged}.
    Not valid for FH/FK ladders (T-dependent potential) or µVT ladders
    (the reduced potential needs mu(T); use per-state averages
    there)."""
    temps, us, ns, fugs = _read_ladder(jsonl_path)
    if fugs is not None:
        raise ValueError("this stream is a fixed-T fugacity-ladder run "
                         "(pt_fug records) — use pt_gcmc_mbar / the "
                         "gcmc-mbar --ladder CLI")
    b0 = int(min(max(skip, 0.0), 0.9) * temps.shape[0])
    temps, us, ns = temps[b0:], us[b0:], ns[b0:]
    ladder = np.unique(np.round(temps.ravel(), 9))
    if ladder.size > temps.shape[1]:
        raise ValueError("ladder temperatures drift across blocks — "
                         "annealing runs cannot be reweighted")
    u_by, n_by = [], []
    for t in ladder:
        sel = np.abs(temps - t) < 1e-8
        u_by.append(us[sel])
        n_by.append(ns[sel])
    fit = mbar_fit(1.0 / ladder, u_by)
    n_all = np.concatenate(n_by)
    if t_grid is None:
        t_grid = np.linspace(ladder[0], ladder[-1], int(n_t))
    t_grid = np.asarray(t_grid, np.float64).ravel()
    u_mean = np.empty_like(t_grid)
    cv = np.empty_like(t_grid)
    n_mean = np.empty_like(t_grid)
    ess = np.empty_like(t_grid)
    for i, t in enumerate(t_grid):
        r = mbar_reweight(fit, 1.0 / t, a_vals=n_all)
        u_mean[i] = r["u_mean"]
        cv[i] = r["u_var"] / (t * t)
        n_mean[i] = r["a_mean"]
        ess[i] = r["ess"]
    return {"t_grid": t_grid, "u_mean": u_mean, "cv_kb": cv,
            "n_mean": n_mean, "ess": ess, "ladder_t": ladder,
            "delta_f": fit["f"], "converged": fit["converged"],
            "samples_per_state": fit["n_k"].astype(int).tolist()}


def _gc_curves(temperature, u_all, nt_all, log_denom, f_grid, y=None,
               ns_all=None):
    """Grand-canonical reweighting curves over a total-fugacity grid
    from pooled samples + MBAR log-denominators: the target reduced
    potential at total fugacity F is u(x) = beta U(x) - sum_s N_s(x)
    ln(y_s F) (composition ray ``y``; with y/ns_all omitted, a single
    sorbate with N = nt_all).  Returns per-grid-point n_mean, u_mean,
    var_n, fluctuation-formula qst [kJ/mol], Kish ESS, and (when
    ns_all [S, Ntot] is given) per-species loading curves."""
    beta = 1.0 / float(temperature)
    f_grid = np.asarray(f_grid, np.float64).ravel()
    n_mean = np.empty_like(f_grid)
    u_mean = np.empty_like(f_grid)
    var_n = np.empty_like(f_grid)
    qst = np.empty_like(f_grid)
    ess = np.empty_like(f_grid)
    per_species = (np.empty((ns_all.shape[0], f_grid.size))
                   if ns_all is not None else None)
    for i, ft in enumerate(f_grid):
        if ns_all is not None and y is not None:
            u_t = beta * u_all - np.log(y * ft) @ ns_all
        else:
            u_t = beta * u_all - np.log(ft) * nt_all
        logw = -u_t - log_denom
        logw -= _logsumexp(logw)
        w = np.exp(logw)
        nm_ = float(np.sum(w * nt_all))
        um_ = float(np.sum(w * u_all))
        vn_ = float(np.sum(w * (nt_all - nm_) ** 2))
        cov = float(np.sum(w * (u_all - um_) * (nt_all - nm_)))
        n_mean[i], u_mean[i], var_n[i] = nm_, um_, vn_
        qst[i] = ((temperature - cov / vn_) * 8.314462618e-3
                  if vn_ > 0 else float("nan"))
        ess[i] = float(1.0 / np.sum(w * w))
        if per_species is not None:
            for s_i in range(ns_all.shape[0]):
                per_species[s_i, i] = float(np.sum(w * ns_all[s_i]))
    return {"n_mean": n_mean, "u_mean": u_mean, "var_n": var_n,
            "qst_kj_mol": qst, "ess": ess, "per_species": per_species}


def pt_gcmc_mbar(jsonl_path, f_grid=None, skip=0.0, n_f=50):
    """Continuous-pressure isotherm + Qst(f) from ONE fixed-T
    fugacity-ladder PT run (mc/run.run_mc_pt_fug): reads the per-block
    ladder records (pt_fug/pt_energy/pt_N) from the run's JSONL
    stream, groups samples by the rung they were recorded at (swaps
    permute the ladder but preserve its values), fits grand-canonical
    MBAR over the K rungs (u_k = beta U - N ln f_k), and reweights to
    ``f_grid``.  The single-run analog of gcmc_mbar over separate
    campaign points.  Returns {f_grid, n_mean, u_mean, var_n,
    qst_kj_mol, ess, ladder_f, delta_f, converged, samples_per_state,
    temperature}."""
    temps, us, ns, fugs = _read_ladder(jsonl_path)
    if fugs is None:
        raise ValueError(f"{jsonl_path}: no pt_fug ladder records — "
                         "this is not a pt_fugacity run (temperature "
                         "ladders reweight with pt_mbar)")
    t0_ = temps.ravel()
    if np.max(np.abs(t0_ - t0_[0])) > 1e-9 * abs(t0_[0]):
        raise ValueError("fugacity-ladder records carry varying "
                         "temperatures — cannot reweight")
    temperature = float(t0_[0])
    b0 = int(min(max(skip, 0.0), 0.9) * fugs.shape[0])
    us, ns, fugs = us[b0:], ns[b0:], fugs[b0:]
    ladder = np.unique(np.round(fugs.ravel(), 12))
    if ladder.size > fugs.shape[1]:
        raise ValueError("ladder fugacities drift across blocks — "
                         "cannot group samples by rung")
    u_by, n_by = [], []
    for fv in ladder:
        sel = np.abs(fugs - fv) < 1e-10 * max(fv, 1.0)
        u_by.append(us[sel])
        n_by.append(ns[sel])
    beta = 1.0 / temperature
    u_all = np.concatenate(u_by)
    n_all = np.concatenate(n_by)
    n_k = np.asarray([len(u) for u in u_by], np.float64)
    u_kn = (beta * u_all[None, :]
            - np.log(ladder)[:, None] * n_all[None, :])
    f, log_denom, converged, its = _mbar_core(u_kn, n_k)
    if f_grid is None:
        f_grid = np.geomspace(ladder[0], ladder[-1], int(n_f))
    f_grid = np.asarray(f_grid, np.float64).ravel()
    curves = _gc_curves(temperature, u_all, n_all, log_denom, f_grid)
    return {"f_grid": f_grid, "n_mean": curves["n_mean"],
            "u_mean": curves["u_mean"], "var_n": curves["var_n"],
            "qst_kj_mol": curves["qst_kj_mol"], "ess": curves["ess"],
            "ladder_f": ladder, "delta_f": f, "converged": converged,
            "iterations": its,
            "samples_per_state": n_k.astype(int).tolist(),
            "temperature": temperature}


def _read_gc_run(path):
    """One GCMC run's (meta, U [n], N [n], per-species N dict) from its
    JSONL stream: the ``run_meta`` header (io/output.py::log_meta)
    defines the state (T, per-species fugacities), the per-corrtime
    block records carry the instantaneous samples."""
    import json
    meta = None
    us, ns = [], []
    nsp = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "run_meta" in rec:
                meta = rec["run_meta"]
                continue
            if "pt_temps" in rec:
                continue
            if "energy_total" in rec and "N" in rec:
                us.append(float(rec["energy_total"]))
                ns.append(float(rec["N"]))
                for k, v in rec.items():
                    if k.startswith("N_"):
                        nsp.setdefault(k[2:], []).append(float(v))
    if meta is None:
        raise ValueError(
            f"{path}: no run_meta header record — re-run with --jsonl "
            "on a current build (io/output.py writes the header), or "
            "pass states explicitly via gcmc_mbar(..., fugacities=)")
    if not us:
        raise ValueError(f"{path}: no observable block records")
    return (meta, np.asarray(us, np.float64), np.asarray(ns, np.float64),
            {k: np.asarray(v, np.float64) for k, v in nsp.items()})


def gcmc_mbar(paths, skip=0.0, f_grid=None, n_f=50, fugacities=None,
              temperature=None):
    """Continuous-fugacity isotherm from K separate GCMC runs at the
    same temperature via grand-canonical MBAR reweighting: the K runs
    (e.g. a campaign's pressure points) are pooled and reweighted to a
    fugacity grid, giving <N>(f), <U>(f), and a continuous-pressure
    isosteric heat from the fluctuation formula — the histogram-
    reweighting workflow the reference's users run by hand on top of
    per-point output files (SURVEY.md §2 "Averages/observables";
    beyond-reference analyzer like pt_mbar).

    The grand-canonical reduced potential at state k is
    u_k(x) = beta U(x) - sum_s N_s(x) ln f_ks  (the beta V / Lambda^3 /
    N! factors are state-independent at fixed T,V and cancel in MBAR).
    Mixtures reweight along the composition ray of the first run.

    ``paths``: JSONL streams, each with a run_meta header (T and
    per-species fugacities are read from the stream; override with
    ``fugacities`` [K][S] + ``temperature``).  ``skip``: equilibration
    fraction dropped per run.  Returns {f_grid [atm], n_mean, u_mean,
    var_n, qst_kj_mol, ess, n_species {name: curve}, ladder_f,
    delta_f (dimensionless grand-potential differences vs state 0),
    converged, samples_per_state, temperature, composition}."""
    if len(paths) < 2:
        raise ValueError("gcmc_mbar needs >= 2 runs (states) to bridge")
    runs = [_read_gc_run(p) for p in paths]
    metas = [r[0] for r in runs]
    if temperature is None:
        temps = [m.get("temperature") for m in metas]
        if any(t is None for t in temps):
            raise ValueError("a run_meta lacks temperature — pass "
                             "temperature= explicitly")
        temperature = float(temps[0])
        if max(abs(t - temperature) for t in temps) > 1e-6 * temperature:
            raise ValueError(f"runs are at different temperatures "
                             f"{temps} — GC reweighting needs one T "
                             "(use pt_mbar for T ladders)")
    for m in metas:
        if m.get("ensemble", "uvt") != "uvt":
            raise ValueError(f"ensemble {m.get('ensemble')!r} run in "
                             "the input — gcmc_mbar reweights uVT runs")
    beta = 1.0 / float(temperature)
    species = metas[0].get("species", [])
    if fugacities is not None:
        fug = np.asarray(fugacities, np.float64)
        if fug.ndim == 1:
            fug = fug[:, None]
        if not species:
            species = [f"sp{j}" for j in range(fug.shape[1])]
    else:
        try:
            fug = np.asarray([m["fugacities"] for m in metas],
                             np.float64)
        except KeyError:
            raise ValueError("a run_meta lacks fugacities — pass "
                             "fugacities= explicitly")
        for m in metas:
            if m.get("species", species) != species:
                raise ValueError("runs have different species lists")
    # sorbate candidates = species with a nonzero fugacity anywhere
    sorb = [j for j in range(fug.shape[1]) if fug[:, j].max() > 0.0]
    if not sorb:
        raise ValueError("no species has a nonzero fugacity")
    # per-sample per-sorbate loadings; single-sorbate runs may predate
    # per-species N_<name> columns -> fall back to the total N
    u_parts, n_parts = [], []
    nsp_parts = {species[j]: [] for j in sorb}
    n_k = []
    for meta, us, ns, nsp in runs:
        k0 = int(min(max(skip, 0.0), 0.9) * len(us))
        us, ns = us[k0:], ns[k0:]
        u_parts.append(us)
        n_parts.append(ns)
        n_k.append(len(us))
        for j in sorb:
            nm = species[j]
            if nm in nsp:
                nsp_parts[nm].append(np.asarray(nsp[nm][k0:]))
            elif len(sorb) == 1:
                nsp_parts[nm].append(ns)
            else:
                raise ValueError(f"run lacks per-species N_{nm} "
                                 "records needed for a mixture")
    u_all = np.concatenate(u_parts)
    n_all = np.concatenate(n_parts)
    ns_cand = {species[j]: np.concatenate(nsp_parts[species[j]])
               for j in sorb}
    # drop constant-loading species (e.g. a frozen framework listed
    # with the default f = P): a constant N_s contributes only a
    # state-constant to u_kn — identical MBAR weights — but would
    # pollute the grand-potential differences with -N_s ln(f_k/f_0)
    sorb = [j for j in sorb if ns_cand[species[j]].var() > 0.0]
    if not sorb:
        raise ValueError("no sorbate's loading varies across the "
                         "pooled samples — nothing to reweight")
    if (fug[:, sorb] <= 0.0).any():
        raise ValueError("a sorbate has fugacity 0 in one run — that "
                         "state forbids the others' samples (ln f "
                         "diverges); drop the run or the species")
    ns_all = np.stack([ns_cand[species[j]] for j in sorb])  # [S, Ntot]
    n_k = np.asarray(n_k, np.float64)
    lnf = np.log(fug[:, sorb])                    # [K, S]
    u_kn = beta * u_all[None, :] - lnf @ ns_all   # [K, Ntot]
    f, log_denom, converged, its = _mbar_core(u_kn, n_k)
    # composition ray from state 0 (checked against the others)
    f_tot_ladder = fug[:, sorb].sum(axis=1)
    y = fug[0, sorb] / f_tot_ladder[0]
    comp = fug[:, sorb] / f_tot_ladder[:, None]
    comp_ok = bool(np.max(np.abs(comp - y[None, :])) < 1e-6)
    if f_grid is None:
        f_grid = np.geomspace(f_tot_ladder.min(), f_tot_ladder.max(),
                              int(n_f))
    f_grid = np.asarray(f_grid, np.float64).ravel()
    nt_all = ns_all.sum(axis=0)                   # total sorbate count
    curves = _gc_curves(float(temperature), u_all, nt_all, log_denom,
                        f_grid, y=y, ns_all=ns_all)
    n_species = {species[j]: curves["per_species"][s_i]
                 for s_i, j in enumerate(sorb)}
    return {"f_grid": f_grid, "n_mean": curves["n_mean"],
            "u_mean": curves["u_mean"], "var_n": curves["var_n"],
            "qst_kj_mol": curves["qst_kj_mol"], "ess": curves["ess"],
            "n_species": n_species, "ladder_f": f_tot_ladder,
            "delta_f": f, "converged": converged, "iterations": its,
            "samples_per_state": n_k.astype(int).tolist(),
            "temperature": float(temperature),
            "composition": {species[j]: float(y[s_i])
                            for s_i, j in enumerate(sorb)},
            "composition_matched": comp_ok}


def _read_series(path, column):
    """A scalar column from an energy CSV (header row) or a JSONL
    observable stream."""
    import json
    vals = []
    with open(path) as f:
        first = f.readline()
        if first.lstrip().startswith("{"):
            for line in [first] + f.readlines():
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if column in rec:
                    vals.append(float(rec[column]))
        else:
            cols = [c.strip() for c in first.strip().split(",")]
            if column not in cols:
                raise ValueError(f"column {column!r} not in {cols}")
            k = cols.index(column)
            for line in f:
                t = line.strip().split(",")
                if len(t) > k and t[k]:
                    vals.append(float(t[k]))
    if not vals:
        raise ValueError(f"no values for column {column!r} in {path}")
    return np.asarray(vals)


def tmmc_lnpi(c):
    """Macrostate log-probabilities lnΠ(N) from a TMMC collection matrix.

    ``c`` is [K, 4]: per-macrostate (n_ins_attempts, Σ a_ins,
    n_del_attempts, Σ a_del) — each µVT insert/delete attempt adds its
    acceptance PROBABILITY, not the realized accept
    (mc/metropolis.make_step_fn; io/output.write_tmmc).  Exception:
    under polar delayed acceptance (polar_delayed) the entry is the
    estimator X = 1{stage-1 accept}·min(1,a2) (importance-weighted
    under tmmc_bias) — unbiased for the DA kernel's acceptance
    probability but a realized-indicator × probability product, so the
    machine-precision links below hold only in expectation on PDA runs
    (make_step_fn's tmmc_on note; r4 advisor).  Detailed balance of
    the sampled chain gives
        lnΠ(N+1) − lnΠ(N) = ln P(N→N+1) − ln P(N+1→N)
                          = ln ā_ins(N) − ln ā_del(N+1),
    where ā is the conditional mean acceptance probability of attempts
    from macrostate N; the insert/delete selection probabilities cancel
    because make_branch_picker splits them exactly 50/50.  Normalizing
    per attempt type (instead of per row) removes the move-type-mix
    sampling noise: on the ideal gas the links are exact to machine
    precision after any number of steps (tests/test_tmmc.py).  The chain
    is followed over one contiguous window where both links have data;
    outside it lnΠ is NaN.  Summed matrices from independent runs
    (tmmc_load) can carry several DISCONNECTED fragments — the fragment
    holding the most insert/delete attempts is the one followed (the
    others cannot be stitched to it without a bridging link), with a
    warning when more than one exists.  Returns lnΠ normalized to max 0.
    """
    c = np.asarray(c, np.float64)
    a_up = np.where(c[:, 0] > 0, c[:, 1] / np.maximum(c[:, 0], 1.0), 0.0)
    a_dn = np.where(c[:, 2] > 0, c[:, 3] / np.maximum(c[:, 2], 1.0), 0.0)
    K = c.shape[0]
    lnpi = np.full(K, np.nan)
    linked = [a_up[i] > 0 and a_dn[i + 1] > 0 for i in range(K - 1)]
    if not any(linked):
        raise ValueError("collection matrix has no connected N→N+1 link "
                         "(no insert/delete statistics yet)")
    # maximal runs of consecutive links -> candidate windows [i0, i1]
    frags, i = [], 0
    while i < K - 1:
        if linked[i]:
            j = i
            while j < K - 1 and linked[j]:
                j += 1
            frags.append((i, j))    # rows i..j inclusive
            i = j
        i += 1
    if len(frags) > 1:
        import warnings
        warnings.warn(
            f"TMMC collection has {len(frags)} disconnected N-windows "
            f"({', '.join(f'{a}..{b}' for a, b in frags)}); following the "
            "best-sampled one — extend runs to bridge the gaps",
            stacklevel=2)
    i0, i1 = max(frags,
                 key=lambda ab: c[ab[0]:ab[1] + 1, [0, 2]].sum())
    lnpi[i0] = 0.0
    for i in range(i0, i1):
        lnpi[i + 1] = lnpi[i] + np.log(a_up[i]) - np.log(a_dn[i + 1])
    return lnpi - np.nanmax(lnpi)


def tmmc_eta(c):
    """Flat-histogram bias η(N) = −lnΠ̂(N) from a collection matrix
    (RunConfig.tmmc_bias), with rows outside the resolved window filled
    by the nearest resolved value (flat extension — the walker is drawn
    toward, not shoved past, the frontier where statistics exist).
    None while no N→N+1 link is resolved yet."""
    try:
        lnpi = tmmc_lnpi(c)
    except ValueError:
        return None
    eta = -lnpi
    idx = np.flatnonzero(np.isfinite(eta))
    eta[:idx[0]] = eta[idx[0]]
    eta[idx[-1] + 1:] = eta[idx[-1]]
    return np.nan_to_num(eta, nan=float(np.nanmax(eta)))


def tmmc_reweight(lnpi, f_sim, f_target):
    """(⟨N⟩, var N, edge probability) of the macrostate distribution
    reweighted from the sampled fugacity to ``f_target``:
    lnΠ'(N) = lnΠ(N) + N ln(f_target/f_sim) (grand-canonical identity —
    only the activity ratio enters).  ``edge`` is the probability mass on
    the outermost resolved macrostates: large edge means the target
    distribution leaks outside the sampled window (truncation bias)."""
    lnpi = np.asarray(lnpi, np.float64)
    ok = np.isfinite(lnpi)
    n = np.flatnonzero(ok).astype(np.float64)
    w = lnpi[ok] + n * (np.log(f_target) - np.log(f_sim))
    w -= w.max()
    p = np.exp(w)
    p /= p.sum()
    mean = float((n * p).sum())
    var = float((((n - mean) ** 2) * p).sum())
    return mean, var, float(p[0] + p[-1])


def tmmc_load(paths):
    """Load + sum same-state TMMC collection files (io/output.write_tmmc).
    Returns (C summed, metadata of the first file).  Summing is valid
    only for runs at identical (T, fugacity, volume) — enforced."""
    import json as _json
    metas, cs = [], []
    for p in paths:
        with open(p) as f:
            rec = _json.load(f)
        if rec.get("format") != "mpmc_tpu.tmmc.v1":
            raise ValueError(f"{p}: not a mpmc_tpu tmmc file")
        metas.append(rec)
        cs.append(np.asarray(rec["c"], np.float64))
    m0 = metas[0]
    for p, m in zip(paths[1:], metas[1:]):
        for k in ("temperature", "fugacities_atm", "volume_a3",
                  "f_sim_atm"):
            if k not in m0:
                continue        # legacy v1 file without the field
            if not np.allclose(m.get(k, m0[k]), m0[k], rtol=1e-10):
                raise ValueError(
                    f"{p}: {k}={m[k]} differs from {paths[0]}'s "
                    f"{m0[k]} — collection matrices only sum at the "
                    "same thermodynamic state")
        if m["c"] and len(m["c"]) != len(m0["c"]):
            raise ValueError(f"{p}: matrix size mismatch")
    return sum(cs), m0


def tmmc_isotherm(c, f_sim, f_targets):
    """[(f, ⟨N⟩, var N, edge mass)] rows from one collection matrix —
    the single-run continuous-fugacity isotherm (the TMMC counterpart of
    ``gcmc_mbar``; exact in the sampled window)."""
    lnpi = tmmc_lnpi(c)
    return [(float(f),) + tmmc_reweight(lnpi, f_sim, f)
            for f in f_targets]


def _pin_cpu():
    """Host-side analysis never needs an accelerator, and the PQR cell
    conversion touches jnp — pin the CPU backend so the standalone CLI
    works on login nodes and never reserves a GPU's memory.  Called
    ONLY from the ``python -m mpmc_tpu.analyze`` entry below: in-process
    callers (tests, scripts that later run on the GPU) must not have
    their whole process silently CPU-pinned."""
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass   # backend already initialized


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mpmc_tpu.analyze",
        description="PQR trajectory analysis (RDF, COM density grids)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("rdf", help="radial distribution function")
    pr.add_argument("traj")
    pr.add_argument("--a", default="*", help="atom name selection A")
    pr.add_argument("--b", default="*", help="atom name selection B")
    pr.add_argument("--flag-a", default="*", choices=["*", "M", "F"])
    pr.add_argument("--flag-b", default="*", choices=["*", "M", "F"])
    pr.add_argument("--rmax", type=float, default=10.0)
    pr.add_argument("--bins", type=int, default=200)
    pr.add_argument("--out", default="-", help="CSV path (default stdout)")
    pd = sub.add_parser("density", help="sorbate COM density -> OpenDX")
    pd.add_argument("traj")
    pd.add_argument("--mol", default="*", help="molecule name selection")
    pd.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pd.add_argument("--resolution", type=float, default=0.7,
                    help="target bin edge length (A)")
    pd.add_argument("--out", required=True, help=".dx output path")
    pm = sub.add_parser("msd", help="COM mean-square displacement")
    pm.add_argument("traj")
    pm.add_argument("--mol", default="*", help="molecule name selection")
    pm.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pm.add_argument("--max-lag", type=int, default=0,
                    help="largest frame lag (default: n_frames-1)")
    pm.add_argument("--out", default="-", help="CSV path (default stdout)")
    pl = sub.add_parser("loading", help="per-frame molecule counts")
    pl.add_argument("traj")
    pl.add_argument("--mol", default="*", help="molecule name selection")
    pl.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pl.add_argument("--out", default="-", help="CSV path (default stdout)")
    pcl = sub.add_parser("cluster",
                         help="sorbate COM cluster statistics per "
                              "frame (connected components under a "
                              "min-image cutoff)")
    pcl.add_argument("traj")
    pcl.add_argument("--mol", default="*", help="molecule name selection")
    pcl.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pcl.add_argument("--rc", type=float, default=4.0,
                     help="COM bonding cutoff (A)")
    pcl.add_argument("--max-size", type=int, default=64,
                     help="histogram bins (size >= max-size pools in "
                          "the last bin)")
    pcl.add_argument("--out", default="-", help="CSV path (default "
                                                "stdout)")
    pb = sub.add_parser("blocking",
                        help="Flyvbjerg-Petersen error analysis of an "
                             "energy-CSV / JSONL observable column")
    pb.add_argument("series", help="energy CSV or --jsonl stream path")
    pb.add_argument("--column", default="energy_total")
    pb.add_argument("--out", default="-", help="CSV path (default stdout)")
    po = sub.add_parser("orient",
                        help="orientational autocorrelation C1/C2 of "
                             "molecular axes")
    po.add_argument("traj")
    po.add_argument("--mol", default="*", help="molecule name selection")
    po.add_argument("--flag", default="M", choices=["*", "M", "F"])
    po.add_argument("--axis", default="*",
                    help="atom-name pattern: axis = first two matching "
                         "atoms per molecule")
    po.add_argument("--max-lag", type=int, default=0,
                    help="largest frame lag (default: n_frames-1)")
    po.add_argument("--out", default="-", help="CSV path (default stdout)")
    ps = sub.add_parser("sq", help="Debye static structure factor S(q)")
    ps.add_argument("traj")
    ps.add_argument("--a", default="*", help="atom name selection")
    ps.add_argument("--flag", default="*", choices=["*", "M", "F"])
    ps.add_argument("--qmin", type=float, default=0.2, help="1/A")
    ps.add_argument("--qmax", type=float, default=12.0, help="1/A")
    ps.add_argument("--nq", type=int, default=200)
    ps.add_argument("--dr-bin", type=float, default=0.005,
                    help="internal pair-distance bin width (A)")
    ps.add_argument("--out", default="-", help="CSV path (default stdout)")
    pq = sub.add_parser("qst",
                        help="isosteric heat from a stored (N, U) "
                             "corrtime series (fluctuation formula)")
    pq.add_argument("series", help="energy CSV or JSONL stream path")
    pq.add_argument("--temperature", "-T", type=float, required=True)
    pq.add_argument("--n-column", default="N")
    pq.add_argument("--u-column", default="energy_total")
    pq.add_argument("--skip", type=float, default=0.0,
                    help="equilibration fraction to drop (0-0.9)")
    pq.add_argument("--blocks", type=int, default=10,
                    help="jackknife block count")
    pc = sub.add_parser("qst-cc",
                        help="Qst(loading) from two isotherm CSVs at "
                             "different temperatures "
                             "(Clausius-Clapeyron)")
    pc.add_argument("csv1")
    pc.add_argument("csv2")
    pc.add_argument("--t1", type=float, required=True)
    pc.add_argument("--t2", type=float, required=True)
    pc.add_argument("--p-column", default="pressure_atm")
    pc.add_argument("--q-column", default="n_mean")
    pc.add_argument("--n-loadings", type=int, default=20)
    pc.add_argument("--out", default="-", help="CSV path (default stdout)")
    pi = sub.add_parser("isofit",
                        help="fit an isotherm model to P,loading points")
    pi.add_argument("csv", help="CSV with pressure + loading columns "
                                "(campaign.py output works directly)")
    pi.add_argument("--model", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pi.add_argument("--p-column", default="pressure_atm",
                    help="campaign.py write_csv column names are the "
                         "defaults")
    pi.add_argument("--q-column", default="n_mean")
    pi.add_argument("--sem-column", default="",
                    help="optional per-point 1-sigma column for "
                         "weighted residuals (campaign: n_sem)")
    pa = sub.add_parser("iast",
                        help="binary IAST mixture prediction from two "
                             "pure-component isotherm CSVs")
    pa.add_argument("csv1", help="pure isotherm of component 1")
    pa.add_argument("csv2", help="pure isotherm of component 2")
    pa.add_argument("--y1", type=float, required=True,
                    help="gas-phase mole fraction of component 1")
    pa.add_argument("--pressures", type=float, nargs="+", required=True,
                    help="total pressures to predict at")
    pa.add_argument("--model1", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pa.add_argument("--model2", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pa.add_argument("--p-column", default="pressure_atm")
    pa.add_argument("--q-column", default="n_mean")
    pa.add_argument("--out", default="-", help="CSV path (default stdout)")
    pw = sub.add_parser("widom", help="Widom test-particle insertion "
                                      "(single LJ site, or a rigid "
                                      "multi-site charged template)")
    pw.add_argument("traj")
    pw.add_argument("--eps", type=float,
                    help="single-site LJ epsilon (K)")
    pw.add_argument("--sig", type=float,
                    help="single-site LJ sigma (A)")
    pw.add_argument("--insert-pqr",
                    help="insertion-template PQR (insert_input deck): "
                         "rigid multi-site LJ + cutoff-Coulomb ghost "
                         "with random orientations")
    pw.add_argument("--temperature", "-T", type=float, required=True)
    pw.add_argument("--tries", type=int, default=2000,
                    help="insertions per frame")
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--rc", type=float, default=10.0, help="cutoff (A)")
    pmb = sub.add_parser("mbar",
                         help="continuous-T observables from one "
                              "NVT parallel-tempering run (MBAR "
                              "reweighting of the JSONL ladder "
                              "records)")
    pmb.add_argument("jsonl", help="PT run --jsonl stream (needs the "
                                   "pt_temps ladder records)")
    pmb.add_argument("--skip", type=float, default=0.0,
                     help="equilibration fraction to drop (0-0.9)")
    pmb.add_argument("--nt", type=int, default=50,
                     help="temperature grid points")
    pmb.add_argument("--tmin", type=float, default=0.0,
                     help="grid start (default: ladder min)")
    pmb.add_argument("--tmax", type=float, default=0.0,
                     help="grid end (default: ladder max)")
    pmb.add_argument("--out", default="-",
                     help="CSV path (default stdout)")
    pgc = sub.add_parser("gcmc-mbar",
                         help="continuous-fugacity isotherm + Qst "
                              "from K separate GCMC runs at one T "
                              "(grand-canonical MBAR over the runs' "
                              "JSONL streams)")
    pgc.add_argument("jsonl", nargs="+",
                     help=">=2 GCMC run --jsonl streams (run_meta "
                          "headers define each state), or ONE "
                          "pt_fugacity ladder stream with --ladder")
    pgc.add_argument("--ladder", action="store_true",
                     help="input is one fixed-T fugacity-ladder PT "
                          "run (pt_fugacity on): reweight its pt_fug "
                          "ladder records instead of separate runs")
    pgc.add_argument("--skip", type=float, default=0.0,
                     help="equilibration fraction to drop (0-0.9)")
    pgc.add_argument("--nf", type=int, default=50,
                     help="fugacity grid points (geometric)")
    pgc.add_argument("--fmin", type=float, default=0.0,
                     help="grid start (atm; default: ladder min)")
    pgc.add_argument("--fmax", type=float, default=0.0,
                     help="grid end (atm; default: ladder max)")
    pgc.add_argument("--out", default="-",
                     help="CSV path (default stdout)")
    pp2 = sub.add_parser("pore",
                         help="geometric void fraction + pore-size "
                              "distribution (first frame)")
    pp2.add_argument("structure", help="PQR structure / trajectory "
                                       "(first frame is used)")
    pp2.add_argument("--name", default="*", help="atom name selection")
    pp2.add_argument("--flag", default="F", choices=["*", "M", "F"])
    pp2.add_argument("--probe", type=float, default=0.0,
                     help="probe LJ sigma (A); probe radius = sigma/2")
    pp2.add_argument("--points", type=int, default=20000,
                     help="volume sample points")
    pp2.add_argument("--centers", type=int, default=2000,
                     help="Gelb-Gubbins candidate sphere centers")
    pp2.add_argument("--bins", type=int, default=60)
    pp2.add_argument("--seed", type=int, default=0)
    pp2.add_argument("--out", default="-",
                     help="PSD CSV path (default stdout)")
    ptm = sub.add_parser("tmmc",
                         help="transition-matrix lnΠ(N) + reweighted "
                              "continuous-fugacity isotherm from one "
                              "GCMC run (tmmc on)")
    ptm.add_argument("files", nargs="+",
                     help="tmmc.json collection files (tmmc_output; "
                          "same-state files are summed)")
    ptm.add_argument("--fugacities", default="",
                     help="comma list of target fugacities (atm); "
                          "default: geometric grid spanning "
                          "fmin x..fmax x the run fugacity")
    ptm.add_argument("--nf", type=int, default=21,
                     help="grid points for the default geometric grid")
    ptm.add_argument("--fmin-ratio", type=float, default=0.1)
    ptm.add_argument("--fmax-ratio", type=float, default=10.0)
    ptm.add_argument("--out", default="-",
                     help="isotherm CSV path (default stdout)")
    ptm.add_argument("--lnpi-out", default=None,
                     help="also write the lnΠ(N) curve as CSV")
    pa2 = sub.add_parser("asa",
                         help="accessible surface area "
                              "(Shrake-Rupley, first frame)")
    pa2.add_argument("structure", help="PQR structure / trajectory "
                                       "(first frame is used)")
    pa2.add_argument("--name", default="*", help="atom name selection")
    pa2.add_argument("--flag", default="F", choices=["*", "M", "F"])
    pa2.add_argument("--probe", type=float, default=3.64,
                     help="probe LJ sigma (A; default ~N2)")
    pa2.add_argument("--sphere-points", type=int, default=512)
    pa2.add_argument("--seed", type=int, default=0)
    for p in (pr, pd, pm, pl, pw, po, ps, pp2, pa2, pcl):
        p.add_argument("--no-native", action="store_true",
                       help="force the numpy reference implementation")
    args = ap.parse_args(argv)

    def write_csv(path, header, rows):
        out = sys.stdout if path == "-" else open(path, "w")
        try:
            out.write(header + "\n")
            for row in rows:
                out.write(",".join(str(v) for v in row) + "\n")
        finally:
            if out is not sys.stdout:
                out.close()

    if args.cmd == "rdf":
        r, g = rdf(args.traj, args.a, args.b, args.flag_a, args.flag_b,
                   rmax=args.rmax, nbins=args.bins,
                   use_native=not args.no_native)
        write_csv(args.out, "r,g",
                  ((f"{ri:.6f}", f"{gi:.8f}") for ri, gi in zip(r, g)))
    elif args.cmd == "msd":
        m, c = msd(args.traj, args.mol, args.flag, max_lag=args.max_lag,
                   use_native=not args.no_native)
        write_csv(args.out, "lag,msd,samples",
                  ((t, f"{m[t]:.8f}", int(c[t]))
                   for t in range(len(m))))
    elif args.cmd == "loading":
        counts = loading(args.traj, args.mol, args.flag,
                         use_native=not args.no_native)
        write_csv(args.out, "frame,n",
                  ((i, f"{v:g}") for i, v in enumerate(counts)))
    elif args.cmd == "orient":
        c1, c2, cnt = orientation(args.traj, args.mol, args.flag,
                                  args.axis, max_lag=args.max_lag,
                                  use_native=not args.no_native)
        write_csv(args.out, "lag,c1,c2,samples",
                  ((t, f"{c1[t]:.8f}", f"{c2[t]:.8f}", int(cnt[t]))
                   for t in range(len(c1))))
    elif args.cmd == "sq":
        qv = np.linspace(args.qmin, args.qmax, args.nq)
        s, nf = sq(args.traj, qv, args.a, args.flag, dr_bin=args.dr_bin,
                   use_native=not args.no_native)
        write_csv(args.out, "q,sq",
                  ((f"{qi:.6f}", f"{si:.8f}") for qi, si in zip(qv, s)))
    elif args.cmd == "cluster":
        series, hist = cluster(args.traj, args.mol, args.flag,
                               rc=args.rc, max_size=args.max_size,
                               use_native=not args.no_native)
        write_csv(args.out, "frame,n_clusters,mean_size,largest_fraction",
                  ((i, f"{r[0]:g}", f"{r[1]:.6g}", f"{r[2]:.6g}")
                   for i, r in enumerate(series)))
        nz = np.nonzero(hist)[0]
        if nz.size:
            print("pooled cluster-size histogram (size: count):")
            for s in nz:
                tag = f"{s + 1}" if s + 1 < args.max_size \
                    else f">={args.max_size}"
                print(f"  {tag}: {int(hist[s])}")
        if len(series):
            print(f"frames: {len(series)}  "
                  f"<clusters/frame>: {series[:, 0].mean():.3f}  "
                  f"<largest fraction>: {series[:, 2].mean():.4f}")
    elif args.cmd == "qst":
        def col(path, name, alias):
            # JSONL streams use N/energy_total; the energy_output CSV
            # (io/output.py) writes n_molecules/total
            try:
                return _read_series(path, name)
            except ValueError:
                return _read_series(path, alias)
        nn = col(args.series, args.n_column, "n_molecules")
        uu = col(args.series, args.u_column, "total")
        k0 = int(min(max(args.skip, 0.0), 0.9) * len(nn))
        res = qst(nn[k0:], uu[k0:], args.temperature,
                  n_blocks=args.blocks)
        print(f"samples:   {res['samples']} (skipped {k0})")
        print(f"<N>:       {res['n_mean']:.6g} +/- {res['n_sem']:.3g}")
        print(f"Qst (K):   {res['qst']:.6g} +/- {res['qst_sem']:.3g}")
        print(f"Qst (kJ/mol): {res['qst'] * 8.314462618e-3:.6g} "
              f"+/- {res['qst_sem'] * 8.314462618e-3:.3g}")
    elif args.cmd == "qst-cc":
        th, qk = qst_clausius_clapeyron(
            _read_series(args.csv1, args.p_column),
            _read_series(args.csv1, args.q_column), args.t1,
            _read_series(args.csv2, args.p_column),
            _read_series(args.csv2, args.q_column), args.t2,
            n_loadings=args.n_loadings)
        write_csv(args.out, "loading,qst_K,qst_kJ_mol",
                  ((f"{t:.6g}", f"{q:.6g}",
                    f"{q * 8.314462618e-3:.6g}")
                   for t, q in zip(th, qk)))
    elif args.cmd == "iast":
        f1 = isotherm_fit(_read_series(args.csv1, args.p_column),
                          _read_series(args.csv1, args.q_column),
                          model=args.model1)
        f2 = isotherm_fit(_read_series(args.csv2, args.p_column),
                          _read_series(args.csv2, args.q_column),
                          model=args.model2)
        rows = []
        for pt in args.pressures:
            r = iast_binary(f1, f2, args.y1, pt)
            rows.append((f"{pt:g}", f"{r['q1']:.6g}", f"{r['q2']:.6g}",
                         f"{r['q_total']:.6g}",
                         f"{r['selectivity']:.6g}"))
        write_csv(args.out, "p_total,q1,q2,q_total,selectivity", rows)
    elif args.cmd == "isofit":
        pp = _read_series(args.csv, args.p_column)
        qq = _read_series(args.csv, args.q_column)
        se = (_read_series(args.csv, args.sem_column)
              if args.sem_column else None)
        res = isotherm_fit(pp, qq, model=args.model, sem=se)
        print(f"model:     {res['model']}  "
              f"(converged: {res['converged']})")
        for k, v in res["params"].items():
            print(f"  {k:>4s} = {v:.8g}")
        print(f"rmse:      {res['rmse']:.6g}")
        print(f"henry dq/dP (P->0): {res['henry']:.6g}")
    elif args.cmd == "blocking":
        s = _read_series(args.series, args.column)
        sizes, sems, errs, tau = blocking(s)
        write_csv(args.out, "block_size,sem,sem_err",
                  ((int(b), f"{m:.8g}", f"{e:.8g}")
                   for b, m, e in zip(sizes, sems, errs)))
        print(f"samples: {len(s)}  mean: {s.mean():.8g}  "
              f"tau_int: {tau:.2f}  "
              f"sem(plateau): {sems[0] * np.sqrt(tau):.6g}")
    elif args.cmd == "tmmc":
        c, meta = tmmc_load(args.files)
        # the activity ratio reweights ONLY the insert species' N — a
        # second movable species' fugacity must not enter f_sim.  Older
        # v1 files lack the field; fall back to the total with a warning.
        if "f_sim_atm" in meta:
            f_sim = float(meta["f_sim_atm"])
        else:
            f_sim = float(sum(meta["fugacities_atm"]))
            if len([f for f in meta["fugacities_atm"] if f > 0]) > 1:
                print("WARNING: legacy tmmc file without f_sim_atm and "
                      "multiple positive fugacities — using their sum; "
                      "re-run to record the insert species' fugacity")
        if f_sim <= 0:
            raise SystemExit("run metadata has no positive fugacity")
        if args.fugacities:
            targets = [float(v) for v in args.fugacities.split(",")]
        else:
            targets = np.geomspace(args.fmin_ratio * f_sim,
                                   args.fmax_ratio * f_sim, args.nf)
        lnpi = tmmc_lnpi(c)
        ok = np.isfinite(lnpi)
        n_att = int(c[:, 0].sum() + c[:, 2].sum())
        print(f"collection: {n_att:d} insert/delete attempts, "
              "resolved window "
              f"N = {np.flatnonzero(ok).min()}..{np.flatnonzero(ok).max()}"
              f" of 0..{len(lnpi) - 1}  (T={meta['temperature']:g} K, "
              f"f_sim={f_sim:g} atm)")
        rows = tmmc_isotherm(c, f_sim, targets)
        for f, n, v, edge in rows:
            if edge > 1e-6:
                print(f"WARNING: f={f:g} atm puts {edge:.2e} probability "
                      "mass at the window edge — extend the run or "
                      "sample nearer this fugacity")
        write_csv(args.out, "f_atm,n_mean,var_n,edge_mass",
                  ((f"{f:.6g}", f"{n:.8g}", f"{v:.8g}", f"{e:.3g}")
                   for f, n, v, e in rows))
        if args.lnpi_out:
            write_csv(args.lnpi_out, "n,lnpi",
                      ((i, f"{lnpi[i]:.8g}")
                       for i in np.flatnonzero(ok)))
    elif args.cmd == "gcmc-mbar":
        grid = (np.geomspace(args.fmin, args.fmax, args.nf)
                if args.fmax > 0 else None)
        if args.ladder:
            if len(args.jsonl) != 1:
                raise SystemExit("--ladder takes exactly one "
                                 "pt_fugacity run stream")
            res = pt_gcmc_mbar(args.jsonl[0], skip=args.skip,
                               n_f=args.nf, f_grid=grid)
            res["n_species"] = {}
            res["composition_matched"] = True
        else:
            res = gcmc_mbar(args.jsonl, skip=args.skip, n_f=args.nf,
                            f_grid=grid)
        lf = res["ladder_f"]
        print(f"ladder: {lf.size} states at T={res['temperature']:g}, "
              "f_total = " + " ".join(f"{v:g}" for v in lf)
              + f"  (samples/state: {res['samples_per_state']}, "
              f"converged: {res['converged']})")
        if not res["composition_matched"]:
            print("WARNING: run compositions differ — the grid follows "
                  "the FIRST run's composition ray")
        print("delta_f (dimensionless grand potential, vs state 0): "
              + " ".join(f"{v:.4f}" for v in res["delta_f"]))
        sp_names = sorted(res["n_species"])
        hdr = "f_atm,n_mean,u_mean,var_n,qst_kJ_mol,ess" + "".join(
            f",n_{nm}" for nm in sp_names)
        write_csv(args.out, hdr,
                  ((f"{ft:.6g}", f"{n:.8g}", f"{u:.8g}", f"{v:.8g}",
                    f"{q:.6g}", f"{e:.6g}",
                    *(f"{res['n_species'][nm][i]:.8g}"
                      for nm in sp_names))
                   for i, (ft, n, u, v, q, e) in enumerate(zip(
                       res["f_grid"], res["n_mean"], res["u_mean"],
                       res["var_n"], res["qst_kj_mol"], res["ess"]))))
    elif args.cmd == "mbar":
        res = pt_mbar(args.jsonl, skip=args.skip, n_t=args.nt,
                      t_grid=(np.linspace(args.tmin, args.tmax,
                                          args.nt)
                              if args.tmax > 0 else None))
        lt = res["ladder_t"]
        print(f"ladder: {lt.size} states, T = "
              + " ".join(f"{t:g}" for t in lt)
              + f"  (samples/state: {res['samples_per_state']}, "
              f"converged: {res['converged']})")
        print("delta_f (dimensionless, vs coldest): "
              + " ".join(f"{v:.4f}" for v in res["delta_f"]))
        write_csv(args.out, "T,u_mean,cv_kb,n_mean,ess",
                  ((f"{t:.6g}", f"{u:.8g}", f"{c:.8g}", f"{n:.8g}",
                    f"{e:.6g}")
                   for t, u, c, n, e in zip(res["t_grid"],
                                            res["u_mean"],
                                            res["cv_kb"],
                                            res["n_mean"],
                                            res["ess"])))
    elif args.cmd == "pore":
        res = pore(args.structure, args.name, args.flag,
                   probe_sigma=args.probe, n_points=args.points,
                   n_centers=args.centers, seed=args.seed,
                   nbins=args.bins, use_native=not args.no_native)
        print(f"void fraction (probe centers): "
              f"{res['void_fraction']:.6g}")
        print(f"coverable fraction:            "
              f"{res['coverable_fraction']:.6g}")
        print(f"void volume (A^3):             "
              f"{res['void_fraction'] * res['volume']:.6g} "
              f"of {res['volume']:.6g}")
        print(f"largest included sphere r >=   {res['d_max']:.4g} A "
              f"(cap {res['cap']:.4g})")
        write_csv(args.out, "r,psd,cumulative",
                  ((f"{r:.6f}", f"{p:.8g}", f"{c:.8g}")
                   for r, p, c in zip(res["psd_r"], res["psd"],
                                      res["psd_cumulative"])))
    elif args.cmd == "asa":
        res = asa(args.structure, args.name, args.flag,
                  probe_sigma=args.probe, n_sphere=args.sphere_points,
                  seed=args.seed, use_native=not args.no_native)
        print(f"accessible area: {res['area_A2']:.6g} A^2")
        print(f"                 {res['area_m2_g']:.6g} m^2/g")
        print(f"                 {res['area_m2_cm3']:.6g} m^2/cm^3")
        print(f"selection mass:  {res['mass_amu']:.6g} amu; cell "
              f"volume {res['volume_A3']:.6g} A^3")
    elif args.cmd == "widom":
        if args.insert_pqr:
            res = widom_mol(args.traj, args.insert_pqr,
                            args.temperature, n_try=args.tries,
                            seed=args.seed, rc=args.rc,
                            use_native=not args.no_native)
        elif args.eps is None or args.sig is None:
            raise SystemExit("widom needs --eps and --sig, or "
                             "--insert-pqr")
        else:
            res = widom(args.traj, args.eps, args.sig, args.temperature,
                        n_try=args.tries, seed=args.seed, rc=args.rc,
                        use_native=not args.no_native)
        print(f"frames:            {res['n_frames']}")
        print(f"<exp(-U/kT)>:      {res['boltzmann']:.6e}")
        print(f"mu_excess (K):     {res['mu_ex']:.4f}")
        print(f"<U>_0 (K):         {res['u0']:.4f}")
        print(f"K_H (mol/kg/atm):  {res['kh_mol_kg_atm']:.6e}")
    else:
        grid, dims, box = density(args.traj, args.mol, args.flag,
                                  resolution=args.resolution,
                                  use_native=not args.no_native)
        from mpmc_tpu.utils.histogram import PopulationHistogram
        h = PopulationHistogram.__new__(PopulationHistogram)
        h.box = box
        h.dims = np.asarray(dims)
        h.counts = grid
        h.n_frames = 1          # grid is already per-frame averaged
        h.write_dx(args.out)
        print(f"wrote {args.out}: dims {dims}, "
              f"total density {grid.sum():.3f} molecules/frame")
    return 0


if __name__ == "__main__":
    _pin_cpu()
    try:
        sys.exit(main())
    except BrokenPipeError:   # `... | head` closed stdout mid-CSV
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
