"""Tournament cyclic Jacobi pieces shared by the DISORT eigen stage (port of
arts_tpu/ops/eigh_jacobi.py: the round-robin schedule, the division-safe
rotation and the sweep counts).  csrc/disort_fused.cu carries the same
schedule and rotation."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def _tournament(n: int):
    """Round-robin schedule: rounds of disjoint (p, q) pairs covering every
    pair once.  Odd n schedules n+1 players and drops the dummy's pairs."""
    if n % 2:
        return [[(p, q) for (p, q) in r if p < n and q < n]
                for r in _tournament(n + 1)]
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([
            (min(players[i], players[n - 1 - i]), max(players[i], players[n - 1 - i]))
            for i in range(n // 2)
        ])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _rot_cs(app, aqq, apq):
    """(c, s) of the Jacobi rotation zeroing apq, never dividing by apq:
    t = 2 apq sign(d) / (|d| + sqrt(d^2 + 4 apq^2)), d = aqq - app."""
    d = aqq - app
    denom = torch.abs(d) + torch.sqrt(d * d + 4.0 * apq * apq)
    pos = denom > 0.0
    t = torch.where(pos, 2.0 * apq * torch.sign(d) / torch.where(pos, denom, 1.0), 0.0)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    return c, t * c


def _default_sweeps(dtype):
    return 6 if dtype == torch.float32 else 8
