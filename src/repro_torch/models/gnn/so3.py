"""SO(3) machinery for equivariant GNNs: real spherical harmonics, real
Clebsch-Gordan (w3j) coefficients, and Wigner-D matrices built on the
device.

The port of the reference's `models/gnn/so3.py`. The coefficient tables
(`_cg_complex`, `_u_matrix`, `real_cg`, `lm_index`, `irrep_dim`) are numpy
and copied as they are; the per-edge functions are PyTorch.

Conventions: real SH basis ordered m = -l..l, flattened at index l*l + l + m;
l=1 basis is proportional to (y, z, x) (e3nn convention). Complex CG come from
the Racah formula (exact via log-factorials); the real-basis w3j is obtained
with the complex->real unitary and is real after a deterministic global phase.
Wigner-D for l >= 2 is built per edge by the exact CG recursion
    D^l = P_l (D^{l-1} (x) D^1) P_l^T,
so per-edge rotations (the eSCN trick) need no host precomputation.
"""
from __future__ import annotations

from functools import lru_cache
from math import lgamma

import numpy as np
import torch


def lm_index(l: int, m: int) -> int:
    return l * l + l + m


def irrep_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


# ---------------------------------------------------------------------------
# complex Clebsch-Gordan (Racah) and real-basis w3j
# ---------------------------------------------------------------------------

def _f(n: float) -> float:
    return lgamma(n + 1.0)


def _cg_complex(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> via the Racah formula (float64)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = 0.5 * (np.log(2 * j3 + 1.0)
                  + _f(j3 + j1 - j2) + _f(j3 - j1 + j2) + _f(j1 + j2 - j3)
                  - _f(j1 + j2 + j3 + 1)
                  + _f(j3 + m3) + _f(j3 - m3)
                  + _f(j1 - m1) + _f(j1 + m1)
                  + _f(j2 - m2) + _f(j2 + m2))
    s = 0.0
    kmin = max(0, j2 - j3 - m1, j1 - j3 + m2)
    kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    for k in range(int(kmin), int(kmax) + 1):
        lg = (_f(k) + _f(j1 + j2 - j3 - k) + _f(j1 - m1 - k) + _f(j2 + m2 - k)
              + _f(j3 - j2 + m1 + k) + _f(j3 - j1 - m2 + k))
        s += (-1.0) ** k * np.exp(pref - lg)
    return float(s)


@lru_cache(maxsize=None)
def _u_matrix(l: int) -> np.ndarray:
    """Unitary mapping complex SH (CS phase) -> real SH, (2l+1, 2l+1)."""
    u = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    rt2 = 1.0 / np.sqrt(2.0)
    for m in range(-l, l + 1):
        row = l + m
        if m > 0:
            u[row, l + m] = (-1.0) ** m * rt2
            u[row, l - m] = rt2
        elif m == 0:
            u[row, l] = 1.0
        else:  # m < 0
            am = -m
            u[row, l + am] = -1j * (-1.0) ** am * rt2
            u[row, l - am] = 1j * rt2
    return u


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C[m1, m2, m3], shape (2l1+1, 2l2+1, 2l3+1).

    Rows (m3 fixed) are orthonormal: the map V_l1 (x) V_l2 -> V_l3 is an
    isometry, which makes the Wigner recursion exact.
    """
    cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                cc[l1 + m1, l2 + m2, l3 + m3] = _cg_complex(l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = _u_matrix(l1), _u_matrix(l2), _u_matrix(l3)
    cr = np.einsum("au,bv,cw,uvw->abc", u1, u2, np.conj(u3), cc)
    re, im = np.real(cr), np.imag(cr)
    if np.abs(im).max() > np.abs(re).max():
        cr = im
    else:
        cr = re
    resid = min(np.abs(re).max(), np.abs(im).max())
    assert resid < 1e-10, f"real CG not phase-pure: {resid}"
    return np.ascontiguousarray(cr)


def cg_tensor(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    """`real_cg` as a tensor of ``like``'s dtype on its device."""
    return torch.from_numpy(real_cg(l1, l2, l3)).to(like.device, like.dtype)


# ---------------------------------------------------------------------------
# real spherical harmonics (l <= 8)
# ---------------------------------------------------------------------------

def _dfact(n: int) -> float:  # (2m-1)!!
    out = 1.0
    for k in range(n, 0, -2):
        out *= k
    return out


def spherical_harmonics(vec: torch.Tensor, l_max: int, *, eps: float = 1e-12,
                        ) -> torch.Tensor:
    """Real SH of unit-normalized vec (..., 3) -> (..., (l_max+1)^2)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    ct = z / r                       # cos(theta)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    # cos(m phi), sin(m phi) via Chebyshev-style recursion on (x, y)/r_xy
    rxy = torch.sqrt(x * x + y * y + eps)
    cp, sp = x / rxy, y / rxy
    cos_m = [torch.ones_like(ct), cp]
    sin_m = [torch.zeros_like(ct), sp]
    for m in range(2, l_max + 1):
        cos_m.append(cp * cos_m[-1] - sp * sin_m[-1])
        sin_m.append(cp * sin_m[-1] + sp * cos_m[-2])

    # associated Legendre WITHOUT Condon-Shortley (standard real-SH convention)
    P: dict[tuple[int, int], torch.Tensor] = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = _dfact(2 * m - 1) * st ** m
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = float(np.sqrt((2 * l + 1) / (4 * np.pi)
                              * np.exp(_f(l - am) - _f(l + am))))
            if m > 0:
                val = float(np.sqrt(2.0) * k) * cos_m[am] * P[(l, am)]
            elif m == 0:
                val = k * P[(l, 0)]
            else:
                val = float(np.sqrt(2.0) * k) * sin_m[am] * P[(l, am)]
            out.append(val)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Wigner-D (real basis) from rotation matrices, CG recursion
# ---------------------------------------------------------------------------

_PERM = [1, 2, 0]


def wigner_d1(rot: torch.Tensor) -> torch.Tensor:
    """D^1 in the real (y, z, x) basis from rotation matrices (..., 3, 3)."""
    return rot[..., _PERM, :][..., :, _PERM]


def wigner_d_blocks(rot: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """[D^0, D^1, ..., D^l_max] for rotation matrices (..., 3, 3).

    Exact recursion D^l = P (D^{l-1} (x) D^1) P^T with P = real CG(l-1,1;l).
    """
    batch = rot.shape[:-2]
    ds = [torch.ones((*batch, 1, 1), dtype=rot.dtype, device=rot.device)]
    if l_max >= 1:
        ds.append(wigner_d1(rot))
    for l in range(2, l_max + 1):
        p = cg_tensor(l - 1, 1, l, rot)                  # (2l-1, 3, 2l+1)
        dd = torch.einsum("...ac,...bd->...abcd", ds[l - 1], ds[1])
        d_l = torch.einsum("abm,...abcd,cdn->...mn", p, dd, p)
        ds.append(d_l)
    return ds


def rotation_to_z(vec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrices R with R @ v_hat = z_hat, for vec (..., 3).

    R = R_y(-beta) @ R_z(-alpha) with alpha = atan2(y, x), beta = acos(z/r).
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    rxy = torch.sqrt(x * x + y * y + eps)
    ca, sa = x / rxy, y / rxy
    cb, sb = z / r, rxy / r
    # R_z(-alpha)
    one = torch.ones_like(ca)
    zero = torch.zeros_like(ca)
    rz = torch.stack([torch.stack([ca, sa, zero], -1),
                      torch.stack([-sa, ca, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    ry = torch.stack([torch.stack([cb, zero, -sb], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([sb, zero, cb], -1)], -2)
    return ry @ rz


def rotate_irreps(feat: torch.Tensor, d_blocks: list[torch.Tensor],
                  l_max: int) -> torch.Tensor:
    """Apply block-diagonal Wigner-D to features (..., (l_max+1)^2, C)."""
    outs = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) ** 2
        outs.append(torch.einsum("...mn,...nc->...mc", d_blocks[l],
                                 feat[..., lo:hi, :]))
    return torch.cat(outs, dim=-2)
