"""DFT (delay-mode) foreground basis.

The reference README names DFT modes as a supported basis class alongside
DPSS (reference README.md:6); the underlying operator lives in
hera_filters.dspec.dft_operator. This is an in-repo implementation returning
a *real* basis (cosine/sine pairs) so it plugs directly into the solver's
real-arithmetic coefficient layout.
"""

from __future__ import annotations

import numpy as np


def dft_operator(freqs, filter_half_width, fundamental_period=None, cache=None):
    """Real DFT delay basis.

    Delay modes tau_n = n / T for integer n with |tau_n| <= W, where T is the
    fundamental period (default: the observed bandwidth, so modes are the
    usual delay bins; set T > B to oversample delays).

    Returns a float64 (Nfreqs, 2*nmax+1) matrix with columns
    [1, cos(2 pi f tau_1), sin(2 pi f tau_1), ..., cos(2 pi f tau_nmax),
    sin(2 pi f tau_nmax)], spanning the same space as the complex modes
    exp(+-2 pi i f tau_n).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    nf = len(freqs)
    if fundamental_period is None:
        df = float(np.mean(np.diff(freqs))) if nf > 1 else 1.0
        fundamental_period = nf * df
    key = None
    if cache is not None:
        key = (nf, float(freqs[0]), float(freqs[-1]),
               round(float(filter_half_width) * 1e17), float(fundamental_period))
        if key in cache:
            return cache[key]
    nmax = int(np.floor(filter_half_width * fundamental_period))
    cols = [np.ones(nf)]
    for n in range(1, nmax + 1):
        tau = n / fundamental_period
        cols.append(np.cos(2 * np.pi * freqs * tau))
        cols.append(np.sin(2 * np.pi * freqs * tau))
    amat = np.stack(cols, axis=1)
    # normalize columns to unit norm for better-conditioned lstsq inits
    amat = amat / np.linalg.norm(amat, axis=0, keepdims=True)
    if cache is not None:
        cache[key] = amat
    return amat
