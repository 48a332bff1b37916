"""The DPSS foreground bases, the benchmark's own copy.

For a uniform frequency axis and a delay half-width W, the basis is the
set of Slepian sequences whose concentration eigenvalue in |tau| <= W is at
least ``EIGENVAL_CUTOFF``: the top eigenvectors of the tridiagonal operator
that commutes with the concentration matrix (Slepian 1978), their
eigenvalues from the Toeplitz quadratic form through one batched FFT. The
same arithmetic as the host layer's ``models/dpss.py`` at the time the
benchmark was written (the uniform-axis branch), frozen here so that a
change to the program cannot move the inputs. float64 numpy and SciPy on
the host; the operators of one configuration are solved in a pool of
worker processes (SciPy's tridiagonal solver holds the interpreter lock),
started fresh and joined before :func:`operators` returns.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
from scipy.linalg import eigh_tridiagonal

EIGENVAL_CUTOFF = 1e-10
WORKERS = 8


def _slepians(nf, nw, kmax):
    m = np.arange(nf, dtype=np.float64)
    d = ((nf - 1.0 - 2.0 * m) / 2.0) ** 2 * np.cos(2.0 * np.pi * nw / nf)
    e = m[1:] * (nf - m[1:]) / 2.0
    _, v = eigh_tridiagonal(d, e, select="i", select_range=(nf - kmax, nf - 1),
                            lapack_driver="stemr")
    return v[:, ::-1]


def _concentration(vecs, nf, df, half_width):
    """lambda_k = v_k^T rho v_k for the Toeplitz rho[m, n] = 2 W df
    sinc(2 W df (m - n)), through its 2N circulant embedding."""
    m = np.arange(nf, dtype=np.float64)
    r = 2.0 * half_width * df * np.sinc(2.0 * half_width * df * m)
    fc = np.fft.rfft(np.concatenate([r, [0.0], r[:0:-1]])).real
    vpad = np.zeros((vecs.shape[0], 2 * nf))
    vpad[:, :nf] = vecs
    power = np.abs(np.fft.rfft(vpad, axis=1)) ** 2
    wgt = np.full(nf + 1, 2.0)
    wgt[0] = wgt[-1] = 1.0
    return (power @ (fc * wgt)) / (2.0 * nf)


def operator(freqs, dly_ns, cutoff=EIGENVAL_CUTOFF):
    """(nfreqs, nvecs) float64 DPSS basis of delay half-width ``dly_ns``,
    most concentrated first: the sequences whose concentration eigenvalue
    is at least ``cutoff``."""
    freqs = np.asarray(freqs, dtype=np.float64)
    nf = len(freqs)
    half_width = float(dly_ns) / 1e9
    df = float(np.mean(np.diff(freqs)))
    nw = nf * df * half_width
    if 2.0 * half_width * df >= 1.0:
        return np.eye(nf)
    if nw >= nf / 2.0 - 1.0:
        raise ValueError(f"a delay of {dly_ns} ns spans the band: no DPSS cut")
    kmax = int(min(nf, np.ceil(2.0 * nw) + 35))
    vecs = _slepians(nf, nw, kmax)
    keep = _concentration(vecs.T, nf, df, half_width) >= cutoff
    if keep.all():
        raise ValueError(f"the Slepian margin at {dly_ns} ns was too small")
    return np.ascontiguousarray(vecs[:, keep])


def _operator_list(freqs, dlys_ns, cutoff):
    return [operator(freqs, d, cutoff) for d in dlys_ns]


def operators(freqs, dlys_ns, workers=WORKERS, cutoff=EIGENVAL_CUTOFF):
    """The operators of every delay in ``dlys_ns``, in order: the longest
    delays (the most modes) dealt out first, round robin over ``workers``
    spawned processes (in this process where ``workers`` is 1)."""
    dlys = [float(d) for d in dlys_ns]
    if workers <= 1 or len(dlys) < 2 * workers:
        return _operator_list(freqs, dlys, cutoff)
    order = np.argsort(dlys)[::-1]
    shares = [order[w::workers] for w in range(workers)]
    out = [None] * len(dlys)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(_operator_list, np.asarray(freqs), [dlys[i] for i in share],
                               cutoff)
                   for share in shares]
        for share, fut in zip(shares, futures):
            for i, op in zip(share, fut.result()):
                out[i] = op
    return out
