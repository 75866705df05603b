"""The plain reference of the Poisson deployments, in plain PyTorch.

The operator is AlgebraicMultigrid.jl's ``poisson`` gallery on a grid of
any dimension d, as the gallery gives it for a 1-, 2- or 3-tuple: the
2·d-point Dirichlet Laplacian, 2·d on the diagonal and −1 to each grid
neighbour, zero outside the grid (the 3-point stencil on a line, the
5-point on a plane, the 7-point in space).  A vector holds the grid
row-major over ``dims``, the last axis fastest (``x[i * ny + j]`` on an
``(nx, ny)`` grid), the layout of the program's lattice operators.  ``cg``
is a plain conjugate-gradient solver of it in any dtype: the reference put
in the program's place, which the controls run in a lower precision.

It imports nothing of the program under test, and nothing of JAX.
"""

import torch


def apply(x, dims):
    """A·x for x of shape [n] (or [k, n]), n the product of ``dims``, in
    x's dtype: 2·d·X, then along each axis in turn the backward and the
    forward neighbour taken off."""
    X = x.reshape(*x.shape[:-1], *dims)
    Y = 2 * len(dims) * X
    for axis in range(X.dim() - len(dims), X.dim()):
        m = X.shape[axis] - 1
        Y.narrow(axis, 1, m).sub_(X.narrow(axis, 0, m))
        Y.narrow(axis, 0, m).sub_(X.narrow(axis, 1, m))
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
