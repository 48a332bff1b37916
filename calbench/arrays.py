"""The array deployments the benchmark fits: antennas, baselines, operators.

A configuration file (``configs/<name>.json``) names a ``layout`` and its
sizes; :func:`build` turns them into a :class:`Deployment`: antenna
positions, every baseline (i < j) the configuration keeps, its unique
spacing and the DPSS delay half-width of that spacing, which picks its
basis operator. A baseline's length is read as the calibration's host
layer reads it: from the antenna positions stored relative to the Earth's
centre at the site, rotated back to east-north-up, one length for each
spacing and its mirror image (that of its first baseline). A length whose
delay falls on a whole ns then lands on the side that the rotation's
rounding gives it, as in the source's own runs. Plain numpy; nothing here
reads the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LAYOUTS = ("hex", "grid")


class Deployment(NamedTuple):
    antpos: np.ndarray  # (nants, 3) east-north-up metres
    ant1: np.ndarray  # (nbls,) int64, ant1 < ant2
    ant2: np.ndarray  # (nbls,) int64
    uniq: np.ndarray  # (nuniq, 3) unique baseline vectors
    inverse: np.ndarray  # (nbls,) index into uniq
    freqs: np.ndarray  # (nfreqs,) Hz
    op_of_uniq: np.ndarray  # (nuniq,) index into op_dly
    op_dly_ns: np.ndarray  # (nops,) integer delay half-widths, ns
    ecef_rel: np.ndarray  # (nants, 3) positions relative to the site, Earth-centred axes

    @property
    def nants(self):
        return len(self.antpos)

    @property
    def nbls(self):
        return len(self.ant1)

    @property
    def nfreqs(self):
        return len(self.freqs)

    @property
    def op_of_bl(self):
        return self.op_of_uniq[self.inverse]


def hex_lattice(rings, pitch):
    """(nants, 3) positions of a complete hexagonal lattice of ``rings`` rings
    (3 r (r + 1) + 1 antennas) at ``pitch`` metres."""
    pts = []
    for i in range(-rings, rings + 1):
        for j in range(-rings, rings + 1):
            if abs(i + j) <= rings:
                pts.append((pitch * (i + j / 2.0), pitch * j * np.sqrt(3) / 2.0, 0.0))
    return np.asarray(pts)


def grid(nside, pitch):
    """(nside**2, 3) positions of a square grid at ``pitch`` metres."""
    xs, ys = np.meshgrid(np.arange(nside), np.arange(nside))
    pos = np.zeros((nside * nside, 3))
    pos[:, 0] = xs.ravel() * pitch
    pos[:, 1] = ys.ravel() * pitch
    return pos


def enu_rotation(lat_deg, lon_deg):
    """The rotation from Earth-centred axes at the site to east-north-up."""
    lat, lon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.array([
        [-np.sin(lon), np.cos(lon), 0.0],
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)],
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
    ])


def read_lengths(ecef_rel, rot, ant1, ant2):
    """(nbls,) lengths as the host layer reads them: one per spacing and its
    mirror image (the half-space rule of its redundancy grouping, 1 m
    tolerance), that of the first baseline in data order."""
    enu = (rot @ ecef_rel.T).T
    vecs = enu[ant2] - enu[ant1]
    e, n, u = vecs[:, 0], vecs[:, 1], vecs[:, 2]
    flip = (e < -0.5) | ((np.abs(e) <= 0.5) & ((n < -0.5) | ((np.abs(n) <= 0.5) & (u < 0.0))))
    vecs = np.where(flip[:, None], -vecs, vecs)
    _, first, inverse = np.unique(np.round(vecs, 6), axis=0, return_index=True,
                                  return_inverse=True)
    # one 1-D norm a spacing, as the host layer takes it (a 2-D norm rounds
    # the last place otherwise)
    lengths = np.array([np.linalg.norm(v) for v in vecs[first]])
    return lengths[inverse.reshape(-1)]


def delay_ns(length_m, min_dly_ns, offset_ns, horizon=1.0):
    """The DPSS delay half-width of a baseline, whole ns:
    ceil(max(min_dly, length / 0.3 * horizon + offset))."""
    return np.ceil(np.maximum(min_dly_ns, np.asarray(length_m) / 0.3 * horizon + offset_ns))


def build(cfg, nfreqs=None):
    """The :class:`Deployment` of a configuration dict (``configs/*.json``);
    ``nfreqs`` overrides its channel count (CPU rehearsals only)."""
    arr = cfg["array"]
    if arr["layout"] == "hex":
        antpos = hex_lattice(arr["rings"], arr["pitch_m"])
    elif arr["layout"] == "grid":
        antpos = grid(arr["nside"], arr["pitch_m"])
    else:
        raise ValueError(f"unknown layout {arr['layout']!r} (one of {LAYOUTS})")
    iu, ju = np.triu_indices(len(antpos), k=1)
    vecs = antpos[ju] - antpos[iu]
    if arr.get("bllen_max_m") is not None:
        keep = np.linalg.norm(vecs, axis=1) <= arr["bllen_max_m"]
        iu, ju, vecs = iu[keep], ju[keep], vecs[keep]
    uniq, first, inverse = np.unique(np.round(vecs, 6), axis=0, return_index=True,
                                     return_inverse=True)
    inverse = inverse.reshape(-1)
    band = cfg["band"]
    nf = band["nfreqs"] if nfreqs is None else nfreqs
    freqs = band["f0_hz"] + band["df_hz"] * np.arange(nf)
    site = cfg["site"]
    rot = enu_rotation(site["lat_deg"], site["lon_deg"])
    ecef_rel = (rot.T @ antpos.T).T
    basis = cfg["basis"]
    dly = delay_ns(read_lengths(ecef_rel, rot, iu, ju), basis["min_dly_ns"], basis["offset_ns"],
                   basis["horizon"])
    if not np.array_equal(dly, dly[first][inverse]):
        raise ValueError("one spacing reads two delays")
    op_dly, op_of_uniq = np.unique(dly[first], return_inverse=True)
    return Deployment(antpos, iu.astype(np.int64), ju.astype(np.int64), uniq, inverse,
                      freqs, op_of_uniq.reshape(-1), op_dly, ecef_rel)
