"""Robust kernels as IRLS weights.

Counterpart of the JAX package's graph/robust.py. g2o applies rho(e) to
the squared error e = r^T Omega r and reweights by rho'(e)
(RobustKernel::robustify); kernels are chosen per edge by integer id
(types.KERNEL_IDS), so edges with different kernels batch together.
"""

from __future__ import annotations

import torch

from .types import (KERNEL_CAUCHY, KERNEL_DCS, KERNEL_FAIR,
                    KERNEL_GEMAN_MCCLURE, KERNEL_HUBER, KERNEL_NONE,
                    KERNEL_PSEUDO_HUBER, KERNEL_SATURATED, KERNEL_TUKEY,
                    KERNEL_WELSCH)


def robust_rho_and_weight(e: torch.Tensor, kernel: torch.Tensor,
                          delta: torch.Tensor):
    """(rho(e), w = rho'(e)) for squared errors e >= 0, elementwise.

    Kernel formulas follow g2o's robust_kernel_impl.cpp; an unknown id
    gives (0, 0), as jnp.select's default does in the JAX package.
    """
    e = torch.clamp(e, min=0.0)
    d2 = delta * delta
    sqrte = torch.sqrt(e + 1e-20)
    one = torch.ones_like(e)
    zero = torch.zeros_like(e)
    inside = e <= d2
    tk = 1.0 - e / d2
    dcs_s = torch.clamp(2.0 * delta / (delta + e), max=1.0)
    table = (
        (KERNEL_NONE, e, one),
        (KERNEL_HUBER, torch.where(inside, e, 2.0 * delta * sqrte - d2),
         torch.where(inside, one, delta / sqrte)),
        (KERNEL_CAUCHY, d2 * torch.log1p(e / d2), 1.0 / (1.0 + e / d2)),
        # dynamic covariance scaling: s = min(1, 2 delta / (delta + e))
        (KERNEL_DCS, dcs_s * e, dcs_s * dcs_s),
        (KERNEL_FAIR, 2.0 * d2 * (sqrte / delta - torch.log1p(sqrte / delta)),
         1.0 / (1.0 + sqrte / delta)),
        (KERNEL_GEMAN_MCCLURE, d2 * e / (d2 + e), (d2 / (d2 + e)) ** 2),
        (KERNEL_PSEUDO_HUBER, 2.0 * d2 * (torch.sqrt(1.0 + e / d2) - 1.0),
         1.0 / torch.sqrt(1.0 + e / d2)),
        (KERNEL_SATURATED, torch.minimum(e, d2), torch.where(inside, one,
                                                             zero)),
        (KERNEL_TUKEY, torch.where(inside, d2 / 3.0 * (1.0 - tk ** 3),
                                   d2 / 3.0),
         torch.where(inside, tk * tk, zero)),
        (KERNEL_WELSCH, d2 * (1.0 - torch.exp(-e / d2)), torch.exp(-e / d2)),
    )
    rho, w = zero, zero
    for k, r_k, w_k in table:
        sel = kernel == k
        rho = torch.where(sel, r_k, rho)
        w = torch.where(sel, w_k, w)
    return rho, w
