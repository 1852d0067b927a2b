"""Batched Levenberg–Marquardt least squares.

Counterpart of ``detprocess_tpu/ops/lm.py`` (``levenberg_marquardt`` :45,
``batched_lm`` :126): a fixed-iteration, trust-region LM over a batch of
small problems, with forward-mode Jacobians (``torch.func.jacfwd``,
vmapped over the batch, or the caller's closed form, ``jacobian``), each
step's damped normal equations solved batched, and every data-dependent
choice a ``torch.where``, so that nothing on the GPU waits for the host
inside the loop. The residuals and the Jacobian of the current
parameters are kept from step to step (one residual evaluation a step);
on the CPU, where reading a flag costs nothing, only the problems whose
step was accepted get a new Jacobian.

- Parameters are rescaled by |x0| (1 where x0 is 0), so that magnitudes
  far apart stay well conditioned in float32.
- A step is accepted when it lowers the cost and leaves the parameters
  finite; λ then shrinks by ``lambda_down``, else grows by ``lambda_up``,
  and stays within [1e-12, 1e12].
- The covariance is (JᵀJ)⁻¹·2·cost/(R − P) at the result, in the user's
  parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap


class LMResult(NamedTuple):
    params: torch.Tensor      # [B, P]
    cost: torch.Tensor        # [B] final ½·Σr²
    cov: torch.Tensor         # [B, P, P]
    niter: torch.Tensor       # [B] steps accepted
    success: torch.Tensor     # [B] bool


def batched_lm(residual_fn: Callable, x0_batch: torch.Tensor,
               args_batch: tuple = (), max_iter: int = 50,
               lambda0: float = 1e-3, lambda_up: float = 10.0,
               lambda_down: float = 0.3,
               jacobian: Optional[Callable] = None) -> LMResult:
    """Minimize ½‖r(x)‖² for each row of ``x0_batch`` [B, P];
    ``residual_fn(params [P], *args) → [R]`` is written for one problem
    and mapped over the batch (every element of ``args_batch`` has the
    leading batch axis). ``jacobian(params [B, P], *args_batch) →
    [B, R, P]``, when given, is the residuals' Jacobian in closed form
    for the whole batch, used in place of ``jacfwd``."""
    scale = torch.where(x0_batch.abs() > 1e-30, x0_batch.abs(),
                        torch.ones_like(x0_batch))

    def scaled(y, s, *a):
        return residual_fn(y * s, *a)

    res = vmap(scaled)
    if jacobian is None:
        jac = vmap(jacfwd(scaled))
    else:
        def jac(y, s, *a):
            return jacobian(y * s, *a) * s[:, None, :]
    args = tuple(args_batch)

    x = x0_batch / scale
    p = x.shape[-1]
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    lam = torch.full(x.shape[:1], lambda0, dtype=x.dtype, device=x.device)
    r = res(x, scale, *args)
    best = 0.5 * torch.sum(r * r, dim=-1)
    jm = jac(x, scale, *args)                              # [B, R, P]
    accepted = torch.zeros(x.shape[:1], dtype=torch.int64, device=x.device)
    # on the CPU, where a host read costs nothing, only the rows whose step
    # was accepted get a new Jacobian; elsewhere every row does
    on_host = x.device.type == "cpu"
    for _ in range(max_iter):
        g = torch.einsum("brp,br->bp", jm, r)
        h = jm.transpose(-1, -2) @ jm
        damped = h + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(h, dim1=-2, dim2=-1).clamp(min=1e-14))
        delta = torch.linalg.solve_ex(damped + 1e-30 * eye,
                                      -g[..., None])[0][..., 0]
        x_new = x + delta
        r_new = res(x_new, scale, *args)
        new_cost = 0.5 * torch.sum(r_new * r_new, dim=-1)
        improve = (new_cost < best) & torch.isfinite(x_new).all(dim=-1)
        x = torch.where(improve[:, None], x_new, x)
        r = torch.where(improve[:, None], r_new, r)
        best = torch.where(improve, new_cost, best)
        lam = torch.where(improve, lam * lambda_down,
                          lam * lambda_up).clamp(1e-12, 1e12)
        accepted = accepted + improve.to(torch.int64)
        if not on_host:
            jm = jac(x, scale, *args)
        elif bool(improve.any()):
            rows = improve.nonzero()[:, 0]
            jm[rows] = jac(x[rows], scale[rows], *(a[rows] for a in args))

    h = jm.transpose(-1, -2) @ jm
    dof = max(jm.shape[-2] - p, 1)
    cov = (torch.linalg.pinv(h, hermitian=True)
           * (2.0 * best / dof)[:, None, None])
    cov = cov * scale[:, :, None] * scale[:, None, :]
    return LMResult(x * scale, best, cov, accepted, torch.isfinite(best))


def levenberg_marquardt(residual_fn: Callable, x0: torch.Tensor,
                        args: tuple = (), **kwargs) -> LMResult:
    """:func:`batched_lm` for one problem: ``x0`` [P], ``args`` without
    the batch axis; the result without it."""
    r = batched_lm(residual_fn, x0[None],
                   tuple(torch.as_tensor(a)[None] for a in args), **kwargs)
    return LMResult(*(v[0] for v in r))
