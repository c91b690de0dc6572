"""Line-shape temperature laws, evaluated densely with torch.where
(port of arts_tpu/lbl/tmodel.py)."""

from enum import IntEnum

import torch


class Law(IntEnum):
    NONE = 0  # value 0 (absent variable)
    T0 = 1
    T1 = 2
    T2 = 3
    T3 = 4
    T4 = 5
    T5 = 6
    AER = 7
    DPL = 8
    POLY = 9


def eval_law(law, x, t0, t):
    """law: int [...], x: [..., 4] coefficients, t0: [...] reference T,
    t: temperature broadcastable against t0.  Returns [...]."""
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    tr = t0 / t
    safe_tr = torch.where(tr > 0, tr, torch.ones_like(tr))
    log_tr = torch.log(safe_tr)

    values = {
        Law.T0: x0,
        Law.T1: x0 * safe_tr**x1,
        Law.T2: x0 * safe_tr**x1 * (1.0 + x2 * (-log_tr)),
        Law.T3: x0 + x1 * (t - t0),
        Law.T4: (x0 + x1 * (tr - 1.0)) * safe_tr**x2,
        Law.T5: x0 * safe_tr ** (0.25 + 1.5 * x1),
        Law.AER: torch.where(
            t < 250.0,
            x0 + (t - 200.0) * (x1 - x0) / 50.0,
            torch.where(
                t > 296.0,
                x2 + (t - 296.0) * (x3 - x2) / 44.0,
                x1 + (t - 250.0) * (x2 - x1) / 46.0,
            ),
        ),
        Law.DPL: x0 * safe_tr**x1 + x2 * safe_tr**x3,
        Law.POLY: x0 + t * (x1 + t * (x2 + t * x3)),
    }
    out = torch.zeros_like(values[Law.T1])  # the full broadcast shape
    for lid, v in values.items():
        out = torch.where(law == lid, v, out)
    return out


# Line-shape variables, order fixed across the catalog arrays; pressure
# exponent per variable (G and DV scale as P^2, ETA as 1, the rest as P)
VARS = ("G0", "D0", "G2", "D2", "ETA", "FVC", "Y", "G", "DV")
NV = len(VARS)
IG0, ID0, IG2, ID2, IETA, IFVC, IY, IG, IDV = range(NV)
P_POW = (1, 1, 1, 1, 0, 1, 1, 2, 2)
