"""The benchmark's inputs: the configuration's sky and flags, gains from ``--seed``.

The configuration's sky of point sources (fluxes, spectral indices and
directions drawn by numpy's generator on the configuration's sky seed, as
the source demo draws them) is observed by every unique spacing of the
deployment on the card,

    V_u(f) = sum_s S_s (f / f0)^-alpha_s exp(-2 pi i f (b_u . l_s) / c),

then projected onto the spacing's DPSS basis, so that an exact fit exists.
Each slice (one time of the night) multiplies every baseline by its own
complex gains, g_i conj(g_j), drawn on the card from a ``torch.Generator``
on the run's seed: 1 + sigma (x + i y), x and y standard normal. RFI flags,
where a traffic mix asks for them, are bands of 2-23 channels at random
centres (numpy's generator on the mix's RFI seed), the same channels at
every time and baseline, until the mix's fraction of the channels is
flagged. The sky and the flags set how far a fixed number of steps gets,
so they are the deployment's and the mix's, the same in every run: a seed
changes every visibility through the gains, and not the difficulty of the
fit. The sky's arithmetic is the host layer's
``simulate.point_source_visibilities``, the flags its HERA demo's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

C_MS = 299792458.0
FREQ_BLOCK = 128  # channels a step of the sky's sum over sources


class Sky(NamedTuple):
    flux: np.ndarray
    alpha: np.ndarray
    lcos: np.ndarray
    mcos: np.ndarray


def draw_sky(seed, nsrc):
    rng = np.random.default_rng(int(seed))
    flux = rng.gamma(2.0, 1.0, size=nsrc)
    alpha = rng.normal(0.8, 0.2, size=nsrc)
    theta = rng.uniform(0, 2 * np.pi, size=nsrc)
    r = np.sqrt(rng.uniform(0, 1, size=nsrc)) * 0.95
    return Sky(flux, alpha, r * np.cos(theta), r * np.sin(theta))


def rfi_channels(seed, nfreqs, frac):
    """(nfreqs,) bool: the flagged channels."""
    rng = np.random.default_rng(int(seed))
    target = int(frac * nfreqs)
    flagged = np.zeros(nfreqs, dtype=bool)
    while flagged.sum() < target:
        c = int(rng.integers(0, nfreqs))
        w = int(rng.integers(2, 24))
        flagged[max(0, c - w // 2): c + w // 2 + 1] = True
    return flagged


def unique_vis(dep, sky, ops, device):
    """(nuniq, nfreqs) complex128 on ``device``: the sky through each unique
    spacing, projected onto its operator (``ops``: float64 tensors)."""
    f = torch.as_tensor(dep.freqs, dtype=torch.float64, device=device)
    tau = torch.as_tensor((np.outer(dep.uniq[:, 0], sky.lcos)
                           + np.outer(dep.uniq[:, 1], sky.mcos)) / C_MS, device=device)
    flux = torch.as_tensor(sky.flux, device=device)
    alpha = torch.as_tensor(sky.alpha, device=device)
    vis = torch.empty((len(dep.uniq), len(f)), dtype=torch.complex128, device=device)
    for f0 in range(0, len(f), FREQ_BLOCK):
        fb = f[f0:f0 + FREQ_BLOCK]
        spec = flux[None, :] * (fb[:, None] / f[0]) ** (-alpha[None, :])  # (fb, nsrc)
        phase = torch.polar(torch.ones((), dtype=torch.float64, device=device),
                            -2 * np.pi * fb[:, None, None] * tau[None])  # (fb, nuniq, nsrc)
        vis[:, f0:f0 + FREQ_BLOCK] = torch.einsum("fs,fus->uf", spec.to(phase.dtype), phase)
    op_of_uniq = torch.as_tensor(dep.op_of_uniq, device=device)
    for k, a in enumerate(ops):
        idx = torch.nonzero(op_of_uniq == k).reshape(-1)
        v = vis[idx]
        proj = lambda x: (x @ a) @ a.T  # noqa: E731
        vis[idx] = torch.complex(proj(v.real), proj(v.imag))
    return vis


def draw_gains(seed, ntimes, nants, nfreqs, sigma, device):
    """(ntimes, nants, nfreqs) complex128 gains on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    x = torch.randn((ntimes, 2, nants, nfreqs), generator=gen, dtype=torch.float64,
                    device=device)
    return torch.complex(1 + sigma * x[:, 0], sigma * x[:, 1])


def slice_into(dep, vis, gains_t, out, block=8192):
    """One slice's visibilities g_i conj(g_j) V, formed on the card in blocks
    of baselines and written into ``out``, a host (nbls, nfreqs) array of
    the configuration's data dtype."""
    dev = vis.device
    for b0 in range(0, dep.nbls, block):
        sl = slice(b0, b0 + block)
        a0 = torch.as_tensor(dep.ant1[sl], device=dev)
        a1 = torch.as_tensor(dep.ant2[sl], device=dev)
        inv = torch.as_tensor(dep.inverse[sl], device=dev)
        d = gains_t[a0] * torch.conj(gains_t[a1]) * vis[inv]
        out[sl] = d.cpu().numpy().astype(out.dtype)
