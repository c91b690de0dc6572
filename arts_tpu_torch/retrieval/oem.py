"""Optimal Estimation (Rodgers MAP) retrieval: linear, Gauss-Newton and
Levenberg-Marquardt steps driving a differentiable forward model (port of
arts_tpu/retrieval/oem.py).

The Jacobian is torch.func.jacfwd (or jacrev) of the forward model; with
the all-sky model that is a run through the differentiable DISORT route
(simulate_allsky(fast_linalg=False)) and its Jacobi eigh kernel.

Precision: the forward model may run in float32 on the card, but the
normal equations are formed in float64: y and J are cast after the
forward.  Radiances are ~1e-14 W/(m^2 Hz sr), so noise at 1e-4 of them
puts S_e near 1e-36, at float32's smallest normal number.  The state has
few elements, so the float64 algebra costs nothing.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .._cuda import resolve
from ..options import OemMethod, check_option


@dataclasses.dataclass
class OEMResult:
    x: torch.Tensor  # retrieved state
    y_fit: torch.Tensor  # forward model at x
    converged: bool
    n_iter: int
    cost: float  # total chi2 / m
    cost_y: float
    cost_x: float
    gain: Optional[torch.Tensor] = None  # G = (J^T Se^-1 J + Sa^-1)^-1 J^T Se^-1
    averaging_kernel: Optional[torch.Tensor] = None  # A = G J
    jac: Optional[torch.Tensor] = None
    lm_gamma_history: Optional[list] = None


def _cg(A, b, tol=1e-5):
    """Conjugate gradients for A X = b, b a vector or a matrix taken as one
    vector (inner products over all its elements), from X = 0; stops when
    |r|^2 <= tol^2 |b|^2 or after 10 x b.shape[-1] iterations (the
    stopping rule of jax.scipy.sparse.linalg.cg as the JAX oem calls it)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = (r * r).sum()
    atol2 = tol * tol * (b * b).sum()
    for _ in range(10 * b.shape[-1]):
        if not gamma > atol2:
            break
        Ap = A @ p
        alpha = gamma / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = (r * r).sum()
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


def _solve_spd(Am, b, cg=False):
    if cg:
        return _cg(Am, b)
    L = torch.linalg.cholesky(Am)
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def oem(
    forward: Callable,
    x_a,
    y_obs,
    S_a,
    S_e,
    method: str = "gn",
    max_iter: int = 20,
    stop_dx: float = 0.01,
    lm_gamma_start: float = 10.0,
    lm_gamma_inc: float = 4.0,
    lm_gamma_dec: float = 5.0,
    lm_gamma_threshold: float = 1e-4,
    jac_mode: str = "auto",
    verbose: bool = False,
    formulation: str = "nform",
    device=None,
) -> OEMResult:
    """Run a MAP retrieval on `device` (None: the card).

    forward: x -> y, differentiable by torch.func; it receives the float64
    state and may compute in any precision.  method: "li" (one linear
    step), "gn", "lm", optionally with the "_cg" suffix ("gn_cg"...) to
    solve the normal equations by conjugate gradients.  stop_dx:
    convergence when dx' (J^T Se^-1 J + Sa^-1) dx / n_state < stop_dx.
    formulation: "nform" solves the n x n state-space normal equations;
    "mform" the m x m measurement-space system x = x_a + Sa J^T
    (J Sa J^T + Se)^-1 (dy + J dx_a); LM damping in mform scales Sa ->
    Sa/(1+gamma) (equivalent to the nform H + gamma Sa^-1).  S_a and S_e
    may be 1-D (variances of a diagonal covariance) or full matrices.
    """
    check_option(OemMethod, method)
    use_cg = method.endswith("_cg")
    method = method.removesuffix("_cg")
    dev, _ = resolve(device)

    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float64)
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    x_a, y_obs, S_a, S_e = f64(x_a), f64(y_obs), f64(S_a), f64(S_e)
    n = x_a.numel()
    m = y_obs.numel()

    # 1-D covariances are diagonal (variances): the m-axis algebra stays
    # elementwise and never forms an m x m matrix
    diag_e = S_e.ndim == 1
    diag_a = S_a.ndim == 1
    Sa_inv = 1.0 / S_a if diag_a else torch.linalg.inv(S_a)
    Se_inv = 1.0 / S_e if diag_e else torch.linalg.inv(S_e)

    def SeI(v):  # Se^-1 @ v for a vector [m] or a matrix [m, k]
        return Se_inv.reshape((m,) + (1,) * (v.ndim - 1)) * v if diag_e else Se_inv @ v

    def SaI(v):
        return Sa_inv * v if diag_a else Sa_inv @ v

    Sa_inv_mat = torch.diag(Sa_inv) if diag_a else Sa_inv

    if jac_mode == "auto":
        jac_mode = "fwd" if n <= m else "rev"
    fwd_fn = lambda x: forward(x).to(torch.float64)
    jac_t = torch.func.jacfwd if jac_mode == "fwd" else torch.func.jacrev
    jac_fn = jac_t(fwd_fn)

    def cost_parts(x, y):
        dy = y - y_obs
        dx = x - x_a
        return float(dy @ SeI(dy)), float(dx @ SaI(dx))

    x = x_a
    y = fwd_fn(x)
    cy, cx = cost_parts(x, y)
    cost = (cy + cx) / m
    gamma = lm_gamma_start if method == "lm" else 0.0
    gamma_hist = []
    converged = False
    it = 0

    def step_nform(H, g, gamma):
        return _solve_spd(H + gamma * Sa_inv_mat, g, use_cg)  # Marquardt damping by Sa^-1

    def step_mform(J, y, gamma):
        # x+ = x_a + Sa_g J^T (J Sa_g J^T + Se)^-1 (dy + J (x - x_a)),
        # Sa_g = Sa/(1+gamma): identical to nform H + gamma Sa^-1
        Sa_g = S_a / (1.0 + gamma)
        K = Sa_g[:, None] * J.T if diag_a else Sa_g @ J.T
        rhs = (y_obs - y) + J @ (x - x_a)
        JK_Se = J @ K + (torch.diag(S_e) if diag_e else S_e)
        lam = _solve_spd(JK_Se, rhs, use_cg)
        return (x_a + K @ lam) - x

    for it in range(1, max_iter + 1):
        J = jac_fn(x)
        JtSe = SeI(J).T  # [n, m]
        H = JtSe @ J + Sa_inv_mat  # curvature without LM damping
        g = JtSe @ (y_obs - y) - SaI(x - x_a)

        if method == "lm":
            accepted = False
            while not accepted:
                dx = (step_mform(J, y, gamma) if formulation == "mform"
                      else step_nform(H, g, gamma))
                x_try = x + dx
                y_try = fwd_fn(x_try)
                cy_t, cx_t = cost_parts(x_try, y_try)
                cost_try = (cy_t + cx_t) / m
                gamma_hist.append(float(gamma))
                if cost_try <= cost or gamma > 1e10:
                    accepted = True
                    gamma = 0.0 if gamma <= lm_gamma_threshold else gamma / lm_gamma_dec
                else:
                    gamma = max(gamma, lm_gamma_threshold) * lm_gamma_inc
        else:
            dx = (step_mform(J, y, 0.0) if formulation == "mform"
                  else _solve_spd(H, g, use_cg))
            x_try = x + dx
            y_try = fwd_fn(x_try)
            cy_t, cx_t = cost_parts(x_try, y_try)
            cost_try = (cy_t + cx_t) / m

        # Rodgers convergence metric
        d2 = float(dx @ (H @ dx)) / n
        x, y, cy, cx, cost = x_try, y_try, cy_t, cx_t, cost_try
        if verbose:
            print(f"  oem iter {it}: cost={cost:.6e} d2={d2:.3e} gamma={gamma:.2e}")
        if method == "li" or d2 < stop_dx:
            converged = True
            break

    # diagnostics at the solution
    J = jac_fn(x)
    JtSe = SeI(J).T
    H = JtSe @ J + Sa_inv_mat
    if formulation == "mform":
        K = S_a[:, None] * J.T if diag_a else S_a @ J.T
        JK_Se = J @ K + (torch.diag(S_e) if diag_e else S_e)
        G = K @ torch.linalg.inv(JK_Se)  # gain, measurement-space form
    else:
        G = _solve_spd(H, JtSe, use_cg)  # gain matrix
    A = G @ J  # averaging kernel

    return OEMResult(
        x=x, y_fit=y, converged=converged, n_iter=it, cost=cost, cost_y=cy / m,
        cost_x=cx / m, gain=G, averaging_kernel=A, jac=J,
        lm_gamma_history=gamma_hist or None,
    )


def smoothing_error_covariance(A, S_a):
    """(A - I) Sa (A - I)^T: the Rodgers smoothing error."""
    I = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    S_a = torch.as_tensor(S_a).to(A)
    return (A - I) @ S_a @ (A - I).T


def retrieval_error_covariance(G, S_e):
    """G Se G^T: the retrieval covariance that measurement noise induces."""
    return G @ torch.as_tensor(S_e).to(G) @ G.T
