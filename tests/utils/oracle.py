"""Reference-exact NumPy oracle for the interpolation methods.

These are direct per-node re-implementations of the reference's Cython
kernels (written from the behavioral spec in SURVEY.md, not translated
code), used as the correctness oracle for the vectorized device kernels:

  * idw_oracle  — ninpol/_methods/idw.pyx:35-84
  * ls_oracle   — ninpol/_methods/ls.pyx:33-136
  * gls_oracle  — ninpol/_methods/gls.pyx:75-474 (LAPACK dgels via scipy)

They intentionally reproduce reference quirks:
  * IDW exact-hit threshold: squared distance <= float32(1e-15)
    (idw.pyx:53,69).
  * LS 2D guard Izz=1 and the D==0 inverse-distance fallback
    (ls.pyx:79-102).
  * GLS Neumann weight read from the LAST CELL column (w_total-1), not the
    Neumann RHS column (gls.pyx:470-472) — i.e. neumann_ws equals the last
    cell weight.  The "correct" Neumann column is also returned for the
    non-compat mode.
  * GLS skips matrix assembly when n_bface >= n_face (gls.pyx:266-267);
    here that produces zero weights instead of dgels garbage.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import lapack as _lapack


def idw_oracle(grid, target_points, neumann_flag):
    n_target = len(target_points)
    W = np.zeros((n_target, grid.MX_ELEMENTS_PER_POINT))
    eps = np.float64(np.float32(1e-15))
    dim = grid.dim
    for i, point in enumerate(target_points):
        if grid.boundary_points[point] and not neumann_flag[point]:
            continue
        xv = grid.point_coords[point][:dim]
        elems = grid.esup[grid.esup_ptr[point]:grid.esup_ptr[point + 1]]
        total = 0.0
        hit = False
        for j, e in enumerate(elems):
            d2 = float(np.sum((xv - grid.centroids[e][:dim]) ** 2))
            if d2 <= eps:
                W[i, :j] = 0.0
                W[i, j] = 1.0
                hit = True
                break
            d = np.sqrt(d2)
            W[i, j] = 1.0 / d
            total += 1.0 / d
        if not hit and total > 0:
            W[i, :len(elems)] /= total
    return W


def ls_oracle(grid, target_points, neumann_flag, return_denom=False):
    n_target = len(target_points)
    W = np.zeros((n_target, grid.MX_ELEMENTS_PER_POINT))
    denoms = np.ones(n_target)
    for i, point in enumerate(target_points):
        if grid.boundary_points[point] and not neumann_flag[point]:
            continue
        elems = grid.esup[grid.esup_ptr[point]:grid.esup_ptr[point + 1]]
        dv = grid.centroids[elems] - grid.point_coords[point]
        Ix, Iy, Iz = dv.sum(axis=0)
        Ixx = np.sum(dv[:, 0] * dv[:, 0])
        Ixy = np.sum(dv[:, 0] * dv[:, 1])
        Ixz = np.sum(dv[:, 0] * dv[:, 2])
        Iyy = np.sum(dv[:, 1] * dv[:, 1])
        Iyz = np.sum(dv[:, 1] * dv[:, 2])
        Izz = np.sum(dv[:, 2] * dv[:, 2])
        if Iz == 0.0 and Izz == 0.0 and Ixz == 0.0 and Iyz == 0.0:
            Izz = 1.0
        D = (Ixx * (Iyy * Izz - Iyz * Iyz)
             + Ixy * (Iyz * Ixz - Ixy * Izz)
             + Ixz * (Ixy * Iyz - Iyy * Ixz))
        Dabs = (abs(Ixx) * (abs(Iyy * Izz) + Iyz * Iyz)
                + abs(Ixy) * (abs(Iyz * Ixz) + abs(Ixy * Izz))
                + abs(Ixz) * (abs(Ixy * Iyz) + abs(Iyy * Ixz)))
        if abs(D) <= 1e-12 * Dabs:
            dist = np.sqrt(np.sum(dv ** 2, axis=1))
            w = 1.0 / dist
            W[i, :len(elems)] = w / w.sum()
            continue
        lx = (Ix * (Iyz * Iyz - Iyy * Izz)
              + Iy * (Ixy * Izz - Iyz * Ixz)
              + Iz * (Iyy * Ixz - Ixy * Iyz)) / D
        ly = (Ix * (Ixy * Izz - Iyz * Ixz)
              + Iy * (Ixz * Ixz - Ixx * Izz)
              + Iz * (Ixx * Iyz - Ixy * Ixz)) / D
        lz = (Ix * (Iyy * Ixz - Ixy * Iyz)
              + Iy * (Ixx * Iyz - Ixy * Ixz)
              + Iz * (Ixy * Ixy - Ixx * Iyy)) / D
        denom = len(elems) + lx * Ix + ly * Iy + lz * Iz
        denoms[i] = denom / max(len(elems), 1)
        W[i, :len(elems)] = (
            1.0 + lx * dv[:, 0] + ly * dv[:, 1] + lz * dv[:, 2]) / denom
    if return_denom:
        return W, denoms
    return W


def gls_oracle(grid, target_points, permeability, diff_mag,
               neumann_flag, neumann_val, neumann_compat=True,
               return_cond=False):
    """Per-node GLS assembly + dgels solve (gls.pyx:75-474).

    With return_cond=True also returns each node's cond(Mi): at
    near-singular stencils (e.g. rank-deficient 2D boundary corners) the
    dgels output is rounding chaos and parity comparisons must mask them.
    """
    n_target = len(target_points)
    W = np.zeros((n_target, grid.MX_ELEMENTS_PER_POINT))
    Nw = np.zeros(n_target)
    conds = np.zeros(n_target)
    K = np.reshape(permeability, (grid.n_elems, 3, 3))

    for i, point in enumerate(target_points):
        if grid.boundary_points[point] and not neumann_flag[point]:
            continue
        KSetv = grid.esup[grid.esup_ptr[point]:grid.esup_ptr[point + 1]]
        Sv = grid.fsup[grid.fsup_ptr[point]:grid.fsup_ptr[point + 1]]
        Svb = np.asarray([f for f in Sv if grid.boundary_faces[f] == 1],
                         dtype=np.int64)
        n_elem, n_face, n_bface = len(KSetv), len(Sv), len(Svb)
        is_neu = int(neumann_flag[point])

        m = n_elem + 3 * n_face + n_bface
        n = 3 * n_elem + 1
        nrhs = n_elem + is_neu
        Mi = np.zeros((m, n))
        Ni = np.zeros((m, nrhs))

        skip_build = n_bface >= n_face
        if not skip_build:
            xv = grid.point_coords[point]
            loc = {int(e): k for k, e in enumerate(KSetv)}
            dKv = grid.centroids[KSetv] - xv
            for k in range(n_elem):
                Mi[k, 3 * k:3 * k + 3] = dKv[k]
                Mi[k, 3 * n_elem] = 1.0
                Ni[k, k] = 1.0
            j = 0
            for f in Sv:
                n_esuf = grid.esuf_ptr[f + 1] - grid.esuf_ptr[f]
                if n_esuf < 2:
                    continue
                xS = grid.faces_centers[f]
                Nsj = grid.normal_faces[f]
                ks = grid.esuf[grid.esuf_ptr[f]:grid.esuf_ptr[f] + n_esuf]
                eta = max(diff_mag[k] for k in ks)
                T1 = xv - xS
                T2 = np.cross(Nsj, T1)
                tau = np.sqrt(np.sum(T2 ** 2)) ** (-eta)
                tauT2 = tau * T2
                # reference: dgemv("T") on a ROW-major 3x3 buffer — BLAS
                # reads it column-major (= K^T) and transposes again, so
                # the computed vector is K @ N (gls.pyx:320-321).
                nL1 = K[ks[0]] @ Nsj
                nL2 = K[ks[1]] @ Nsj
                I1, I2 = loc[int(ks[0])], loc[int(ks[1])]
                r = n_elem + 3 * j
                Mi[r, 3 * I1:3 * I1 + 3] = -nL1
                Mi[r, 3 * I2:3 * I2 + 3] = nL2
                Mi[r + 1, 3 * I1:3 * I1 + 3] = -T1
                Mi[r + 1, 3 * I2:3 * I2 + 3] = T1
                Mi[r + 2, 3 * I1:3 * I1 + 3] = -tauT2
                Mi[r + 2, 3 * I2:3 * I2 + 3] = tauT2
                j += 1

        if is_neu:
            loc = {int(e): k for k, e in enumerate(KSetv)}
            start = n_elem + 3 * n_face
            for b, f in enumerate(Svb):
                owner = grid.esuf[grid.esuf_ptr[f]]
                nL = K[owner] @ grid.normal_faces[f]
                pts = grid.inpofa[f]
                pts = pts[pts >= 0]
                Ni[start + b, n_elem] = np.mean(neumann_val[pts])
                Ik = loc[int(owner)]
                Mi[start + b, 3 * Ik:3 * Ik + 3] = -nL

        if skip_build and not is_neu:
            continue
        if skip_build:
            # dgels on a rank-deficient system is undefined in the
            # reference; emit zeros (documented deviation).
            continue

        if return_cond:
            sv = np.linalg.svd(Mi, compute_uv=False)
            conds[i] = sv[0] / max(sv[min(m, n) - 1], 1e-300)
        # LAPACK dgels (QR least squares), same driver as the reference.
        lwork = _lapack.dgels_lwork(m, n, nrhs)[0]
        _, B_sol, info = _lapack.dgels(
            Mi, Ni, lwork=int(lwork))
        if info != 0:
            # exactly singular R diagonal: the Cython reference ignores
            # info and reads uninitialized garbage (gls.pyx:457-472);
            # flag the node so comparisons mask it.
            conds[i] = np.inf
            continue
        sol_last = B_sol[n - 1, :]          # last solution row
        w_total = nrhs - is_neu
        W[i, :w_total] = sol_last[:w_total]
        if is_neu:
            if neumann_compat:
                # reference quirk: reads column w_total-1 (gls.pyx:472)
                Nw[i] = sol_last[w_total - 1]
            else:
                Nw[i] = sol_last[w_total]
    if return_cond:
        return W, Nw, conds
    return W, Nw
