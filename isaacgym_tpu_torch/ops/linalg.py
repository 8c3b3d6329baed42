"""Small-matrix Cholesky factor and solve over a leading batch dimension.

Counterpart of ``isaacgym_tpu/ops/linalg.py`` (``:21-73``). For n <= 16 the
factor is the same unrolled scalar recurrence, kept as nested rows
``L[i][j]`` (j <= i) of (B,) tensors, with the 1e-12 floor under each pivot;
for larger n (the 33-column floating-base matrix) it is a dense lower factor
from ``torch.linalg.cholesky_ex``, as the JAX package falls back to the lax
factorization there. The same layout comes out of K1's packed factor through
``ops.arm_step.unpack_chol``.
"""

from __future__ import annotations

import torch

_UNROLL_MAX = 16


def chol_factor(M):
    """Cholesky factor of (B, n, n) SPD matrices: nested rows of (B,)
    tensors for n <= 16, else the dense (B, n, n) lower factor."""
    n = M.shape[-1]
    if n > _UNROLL_MAX:
        return torch.linalg.cholesky_ex(M)[0]
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return tuple(tuple(row) for row in L)


def chol_solve(L, rhs):
    """Solve ``M x = rhs`` given :func:`chol_factor`'s output; ``rhs`` is
    (B, n) or (B, n, m) and the result has its shape."""
    if torch.is_tensor(L):
        if rhs.dim() == 2:
            return torch.cholesky_solve(rhs[..., None], L)[..., 0]
        return torch.cholesky_solve(rhs, L)
    n = len(L)
    ex = (slice(None),) + (None,) * (rhs.dim() - 2)   # (B,) entries against rhs rows
    y = [None] * n
    for i in range(n):
        s = rhs[:, i]
        for j in range(i):
            s = s - L[i][j][ex] * y[j]
        y[i] = s / L[i][i][ex]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for j in range(i + 1, n):
            s = s - L[j][i][ex] * x[j]
        x[i] = s / L[i][i][ex]
    return torch.stack(x, dim=1)
