"""Closed-form symmetric 3x3 eigen-analysis (batched, branch-free).

Counterpart of the JAX package's ops/sym3eig.py: eigenvalues by Cardano's
trigonometric solution, the eigenvector of the smallest one from the
largest cross product of rows of (A - lambda I). The covariance
regularization needs only the smallest eigenvector (the surface normal).
Accuracy ~1e-6 relative on well-separated spectra.
"""

from __future__ import annotations

from typing import Tuple

import torch


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) via Cardano."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = 0.5 * (c00 * (c11 * c22 - c12 * c12)
                      - c01 * (c01 * c22 - c12 * c02)
                      + c02 * (c01 * c12 - c11 * c02))
    angle = torch.arccos(torch.clamp(half_det, -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0943951023931953
    l2 = q + 2.0 * p * torch.cos(angle)
    l0 = q + 2.0 * p * torch.cos(angle + two_pi_3)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric A for the (simple) eigenvalue lam."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = torch.where(best12[..., None], c12,
                    torch.where(best02[..., None], c02, c01))
    nv = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                min=1e-30))
    v = v / nv
    # all cross products ~0 (isotropic block): fall back to the z axis
    degen = torch.maximum(torch.maximum(n01, n02), n12) < 1e-20
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    return torch.where(degen[..., None], ez, v)


def smallest_eigvec3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending, unit eigenvector of the smallest)."""
    w = eigvalsh3(A)
    return w, _eigvec_for(A, w[..., 0])
