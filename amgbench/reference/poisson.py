"""The plain reference of the Poisson deployments, in plain PyTorch.

The operator is AlgebraicMultigrid.jl's ``poisson`` gallery on an
``(nx, ny)`` grid: the 5-point stencil, 4 on the diagonal and −1 to each
grid neighbour, zero (Dirichlet) outside the grid.  A vector holds the grid
row-major, ``x[i * ny + j]``; on a square grid with this symmetric stencil
any ordering of the two axes gives the same matrix.  ``cg`` is a plain
conjugate-gradient solver of it in any dtype: the reference put in the
program's place, which the controls run in a lower precision.

It imports nothing of the program under test, and nothing of JAX.
"""

import torch


def apply(x, dims):
    """A·x for x of shape [n] (or [k, n]), in x's dtype."""
    nx, ny = dims
    X = x.reshape(*x.shape[:-1], nx, ny)
    Y = 4 * X
    Y[..., 1:, :] -= X[..., :-1, :]
    Y[..., :-1, :] -= X[..., 1:, :]
    Y[..., :, 1:] -= X[..., :, :-1]
    Y[..., :, :-1] -= X[..., :, 1:]
    return Y.reshape(x.shape)


def relres(x, b, dims):
    """‖b − A·x‖ / ‖b‖ in float64, x and b on one device."""
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.norm(b64 - apply(x64, dims)) / torch.linalg.norm(b64))


def cg(b, dims, dtype, tol, maxiter):
    """Conjugate gradients on A·x = b from x = 0 in ``dtype``, until the
    recurred residual is at or under ``tol``·‖b‖ or ``maxiter`` steps:
    (x, steps)."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    stop = tol * float(torch.linalg.norm(b.to(torch.float64)))
    steps = 0
    while steps < maxiter and float(rr) ** 0.5 > stop:
        Ap = apply(p, dims)
        alpha = rr / torch.dot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        steps += 1
    return x, steps
