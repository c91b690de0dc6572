"""Sensor observation elements: weighted contractions of simulated radiance
(port of arts_tpu/sensor/obsel.py).

The deduplicated (geometry, frequency) simulation batch is a dense tensor
I[geo, freq(, stokes)]; each measurement element is a list of weights,
y[row] = sum_k w_k I[geo_k, freq_k] over the entries k of that row.  JAX
contracts with a segment sum; on the card a scatter-add would use
floating-point atomics, whose order varies from run to run.  Here the
builders' entries come sorted by row, and `apply` gathers them into a
padded [n_elements, max_entries] table (padding weighs 0) and sums each
row in a fixed order, so that two runs are bit-identical.

The builders are host-side numpy, as in the JAX package; they return
tensors on the caller's device (None: the card), the weights in its
dtype (None: float32) and the indices as int64.
"""

import dataclasses

import numpy as np
import torch

from .._cuda import resolve


def _slots(row, n_elements):
    """[n_elements, max_entries] positions of each row's entries (sorted by
    row) in the entry list, padded with the index of an appended zero."""
    row = np.asarray(row, dtype=np.int64)
    nnz = row.size
    if nnz and np.any(np.diff(row) < 0):
        raise ValueError("SensorArray: entries must be sorted by row")
    counts = np.bincount(row, minlength=n_elements) if nnz else np.zeros(n_elements, np.int64)
    width = max(int(counts.max()) if n_elements else 0, 1)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]) if n_elements else np.zeros(0, np.int64)
    pos = start[:, None] + np.arange(width)[None, :]
    return np.where(np.arange(width)[None, :] < counts[:, None], pos, nnz)


@dataclasses.dataclass(frozen=True)
class SensorArray:
    """Weights y[row[k]] += w[k] I[geo[k], freq[k]] for k < nnz, rows
    sorted; slots [n_elements, max_entries] (derived from row when not
    given) lists each row's entries, padded with nnz."""

    row: torch.Tensor  # [nnz] int64 measurement element index
    geo: torch.Tensor  # [nnz] int64 geometry index
    freq: torch.Tensor  # [nnz] int64 frequency index
    w: torch.Tensor  # [nnz] weights
    n_elements: int = 0
    slots: torch.Tensor | None = None

    def __post_init__(self):
        if self.slots is None:
            slots = _slots(self.row.cpu().numpy(), self.n_elements)
            object.__setattr__(self, "slots", torch.as_tensor(slots, device=self.row.device))

    def apply(self, I):
        """Contract radiance I[geo, freq] (or [geo, freq, stokes]) into the
        measurement vector [n_elements] (or [n_elements, stokes])."""
        vals = I[self.geo, self.freq]
        w = self.w.to(vals.dtype)
        vv = w * vals if vals.ndim == 1 else w[:, None] * vals
        vv = torch.cat([vv, torch.zeros_like(vv[:1])], 0)
        return vv[self.slots].sum(1)


def _sensor(rows, geos, freqs, ws, n_elements, device, dtype):
    dev, dt = resolve(device, dtype)
    ints = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
    return SensorArray(row=ints(rows), geo=ints(geos), freq=ints(freqs),
                       w=torch.as_tensor(np.asarray(ws, dtype=np.float64), dtype=dt, device=dev),
                       n_elements=int(n_elements))


def gaussian_channels(f_grid, centers, fwhm, geo_idx=0, normalize=True, device=None,
                      dtype=None) -> SensorArray:
    """Gaussian channel responses on a shared frequency grid: one element
    per centre, the grid points where the response exceeds 1e-10,
    normalized to unit sum."""
    f_grid = np.asarray(torch.as_tensor(f_grid).cpu(), dtype=np.float64)
    centers = np.atleast_1d(np.asarray(centers, dtype=np.float64))
    fwhm = np.broadcast_to(np.asarray(fwhm, dtype=np.float64), centers.shape)
    geo_idx = np.broadcast_to(np.asarray(geo_idx, dtype=np.int64), centers.shape)
    rows, geos, freqs, ws = [], [], [], []
    for i, (c, fw, g) in enumerate(zip(centers, fwhm, geo_idx)):
        sigma = fw / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        w = np.exp(-0.5 * ((f_grid - c) / sigma) ** 2)
        keep = w > 1e-10
        w = w[keep]
        if normalize and w.sum() > 0:
            w = w / w.sum()
        idx = np.nonzero(keep)[0]
        rows.append(np.full(idx.size, i))
        geos.append(np.full(idx.size, g))
        freqs.append(idx)
        ws.append(w)
    return _sensor(np.concatenate(rows), np.concatenate(geos), np.concatenate(freqs),
                   np.concatenate(ws), len(centers), device, dtype)


def raw_channels(n_freq, geo_idx=0, device=None, dtype=None) -> SensorArray:
    """One element per frequency grid point."""
    idx = np.arange(n_freq)
    return _sensor(idx, np.full(n_freq, geo_idx), idx, np.ones(n_freq), n_freq, device,
                   dtype)


def gaussian_zenith_channels(dzen_grid, std_zen, n_freq, geo_offset=0, normalize=True,
                             device=None, dtype=None) -> SensorArray:
    """Gaussian antenna response over zenith offsets: one element per
    frequency, summing the geometries geo_offset + i (line-of-sight zenith
    centre + dzen_grid[i]) with Gaussian weights."""
    dzen = np.asarray(dzen_grid, dtype=np.float64)
    wg = np.exp(-0.5 * (dzen / float(std_zen)) ** 2)
    if normalize:
        wg = wg / wg.sum()
    G = dzen.size
    return _sensor(np.repeat(np.arange(n_freq), G), np.tile(geo_offset + np.arange(G), n_freq),
                   np.repeat(np.arange(n_freq), G), np.tile(wg, n_freq), n_freq, device, dtype)


def camera_pixels(n_h, n_w, ccd_h, ccd_w, focal_length, focus_distance):
    """Thin-lens camera pixel line-of-sight offsets [(n_h n_w), 2] (dzen,
    dazi) in degrees: image distance d_i = f d_o / (d_o - f), offsets the
    negated arctangents of the CCD displacement (the lens inverts the
    image)."""
    f = float(focal_length)
    d_o = float(focus_distance)
    d_i = f * d_o / (d_o - f)
    ys = (np.arange(n_h) - (n_h - 1) / 2.0) * (ccd_h / n_h)
    xs = (np.arange(n_w) - (n_w - 1) / 2.0) * (ccd_w / n_w)
    dzen = -np.rad2deg(np.arctan2(ys, d_i))
    dazi = -np.rad2deg(np.arctan2(xs, d_i))
    zz, aa = np.meshgrid(dzen, dazi, indexing="ij")
    return np.stack([zz.ravel(), aa.ravel()], axis=-1)


def camera_channels(n_h, n_w, n_freq, geo_offset=0, device=None, dtype=None) -> SensorArray:
    """One element per (pixel, frequency), pixel-major, for a camera whose
    pixels are the geometries geo_offset .. geo_offset + n_h n_w - 1."""
    P = n_h * n_w
    return _sensor(np.arange(P * n_freq), geo_offset + np.repeat(np.arange(P), n_freq),
                   np.tile(np.arange(n_freq), P), np.ones(P * n_freq), P * n_freq, device,
                   dtype)
