"""Lagrange interpolation of configurable order, differentiable (port of
arts_tpu/ops/interp.py): the weights from a static order over a window of
neighbouring nodes, so that evaluation is one gather and a contraction.
"""

import torch


def lagrange_weights(grid, x, order: int):
    """(i0 [...], w [..., order + 1]): the window's first node and the
    weights of its order + 1 nodes at x.

    grid [N] ascending; x any shape, of grid's dtype.  The window is
    clamped inside the grid (the reference's clamped extrapolation)."""
    n = grid.shape[0]
    m = order + 1
    x = torch.as_tensor(x, dtype=grid.dtype, device=grid.device)
    i1 = torch.clamp(torch.searchsorted(grid, x.reshape(-1)).reshape(x.shape), 1, n - 1)
    i0 = torch.clamp(i1 - (m + 1) // 2, 0, max(n - m, 0))
    offs = torch.arange(m, device=grid.device)
    nodes = grid[i0[..., None] + offs]  # [..., m]
    xd = x[..., None] - nodes
    # w_k = prod_{j != k} (x - x_j) / (x_k - x_j)
    eye = torch.eye(m, dtype=torch.bool, device=grid.device)
    one = torch.ones((), dtype=grid.dtype, device=grid.device)
    diff = torch.where(eye, one, nodes[..., :, None] - nodes[..., None, :])  # [..., m, m]
    num = torch.where(eye, one, xd[..., None, :])
    return i0, torch.prod(num / diff, dim=-1)


def interp(grid, values, x, order: int = 1, axis: int = -1):
    """`values` sampled on `grid` along `axis`, interpolated to x: the
    other axes of values, then x's shape.  order 1 is linear
    interpolation; higher orders give the reference's Lagrange
    interpolation for smooth fields."""
    values = torch.movedim(values, axis, -1)
    i0, w = lagrange_weights(grid, x, order)
    offs = torch.arange(order + 1, device=grid.device)
    window = values[..., i0[..., None] + offs]  # [..., x-shape, m]
    return (window * w).sum(-1)
