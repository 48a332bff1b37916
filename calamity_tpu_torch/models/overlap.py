"""uv-plane frequency-overlap fitting groups.

Behavior parity with reference modeling.get_uv_overlapping_grps_conjugated
(modeling.py:84-252): redundant groups whose uv tracks overlap anywhere
across the band are merged into joint "fitting groups" (modeled with shared
multi-baseline components). Two groups connect when

  1. their |uvw| ranges [fmin*L/c, fmax*L/c] overlap,
  2. (optionally) their position angles match within tolerance, and
  3. some pair of frequencies brings their uv points within
     ``red_tol_freq`` wavelengths — testing both direct and conjugated
     orientation (a conjugate match flips the later group's pairs).

Groups are then agglomerated with the reference's greedy label propagation
over groups sorted by (angle, length).
"""

from __future__ import annotations

import numpy as np

from ..utils import PBARS
from .redundancy import get_redundant_grps_data

C_MS = 3e8  # match reference constant (modeling.py:168)


def get_uv_overlapping_grps_conjugated(
    visdata,
    red_tol=1.0,
    include_autos=False,
    red_tol_freq=0.5,
    n_angle_bins=200,
    notebook_progressbar=False,
    require_exact_angle_match=True,
    angle_match_tol=1e-3,
):
    """Returns (fitting_grps, fitting_vec_centers, connections, grp_labels)."""
    _, red_grps, vec_bin_centers, _ = get_redundant_grps_data(
        visdata, include_autos=include_autos, tol=red_tol, remove_redundancy=False
    )
    red_grps = [list(g) for g in red_grps]
    vec_bin_centers = [np.asarray(v, dtype=float) for v in vec_bin_centers]
    freqs = np.asarray(visdata.freq_array[0], dtype=float)
    fmin, fmax = freqs.min(), freqs.max()

    # angular binning: only compare groups within the same bin
    dangle = np.pi / n_angle_bins
    bins = {i: [] for i in range(n_angle_bins)}
    for gi, vbc in enumerate(vec_bin_centers):
        if np.abs(vbc[0]) > 0.0:
            bi = int(
                min(np.round((np.arctan(vbc[1] / vbc[0]) + np.pi / 2) / dangle), n_angle_bins - 2)
            )
        else:
            bi = n_angle_bins - 1
        bins[bi].append(gi)

    connections = {}
    vbc_hash = {}

    def _key(gi):
        return tuple(red_grps[gi])

    def _ensure(gi):
        k = _key(gi)
        if k not in connections:
            connections[k] = set()
            vbc_hash[k] = vec_bin_centers[gi]
        return k

    for binnum in range(n_angle_bins):
        nums = bins[binnum]
        for ii in range(len(nums)):
            g0 = nums[ii]
            k0 = _ensure(g0)
            vbc0 = vec_bin_centers[g0]
            len0 = np.linalg.norm(vbc0)
            for jj in range(ii + 1, len(nums)):
                g1 = nums[jj]
                vbc1 = vec_bin_centers[g1]
                len1 = np.linalg.norm(vbc1)
                lo0, hi0 = fmin * len0 / C_MS, fmax * len0 / C_MS
                lo1, hi1 = fmin * len1 / C_MS, fmax * len1 / C_MS
                if not ((lo1 < lo0 < hi1) or (lo0 < lo1 < hi0)):
                    continue
                if require_exact_angle_match:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        a0 = np.arctan(vbc0[1] / vbc0[0]) if vbc0[0] != 0 else np.pi / 2
                        a1 = np.arctan(vbc1[1] / vbc1[0]) if vbc1[0] != 0 else np.pi / 2
                    if np.abs(a0 - a1) > angle_match_tol:
                        continue
                u0 = vbc0[0] * freqs / C_MS
                v0 = vbc0[1] * freqs / C_MS
                u1 = vbc1[0] * freqs / C_MS
                v1 = vbc1[1] * freqs / C_MS
                du = u0[:, None] - u1[None, :]
                dv = v0[:, None] - v1[None, :]
                direct = np.any(np.hypot(du, dv) <= red_tol_freq)
                if direct:
                    k1 = _ensure(g1)
                    connections[k0].add(k1)
                    connections[k1].add(k0)
                    continue
                su = u0[:, None] + u1[None, :]
                sv = v0[:, None] + v1[None, :]
                if np.any(np.hypot(su, sv) <= red_tol_freq):
                    # conjugate overlap: flip the later group's orientation.
                    # If the group was already registered under its old
                    # orientation (a prior direct connection), MIGRATE that
                    # entry — leaving it would emit the same physical
                    # baselines twice, once per orientation
                    old_k = _key(g1)
                    red_grps[g1] = [ap[::-1] for ap in red_grps[g1]]
                    vec_bin_centers[g1] = -vec_bin_centers[g1]
                    new_k = _key(g1)
                    if old_k in connections:
                        connections[new_k] = connections.pop(old_k)
                        vbc_hash.pop(old_k)
                        vbc_hash[new_k] = vec_bin_centers[g1]
                        for s in connections.values():
                            if old_k in s:
                                s.discard(old_k)
                                s.add(new_k)
                    k1 = _ensure(g1)
                    connections[k0].add(k1)
                    connections[k1].add(k0)

    # greedy label propagation in (angle, length) order (modeling.py:199-241)
    keys = list(vbc_hash.keys())
    lengths = {k: np.linalg.norm(vbc_hash[k]) for k in keys}
    angles = {k: np.arccos(np.clip(vbc_hash[k][0] / max(lengths[k], 1e-30), -1, 1)) for k in keys}
    keys_sorted = sorted(keys, key=lambda k: (angles[k], lengths[k]))

    fitting_grps = {}
    grp_labels = {}
    for k in PBARS[notebook_progressbar](keys_sorted):
        if k not in grp_labels:
            fitting_grps[k] = [k]
            grp_labels[k] = k
            for conn in connections[k]:
                if conn not in grp_labels:
                    fitting_grps[k].append(conn)
                    grp_labels[conn] = k
        else:
            parent = grp_labels[k]
            for conn in connections[k]:
                if conn not in grp_labels:
                    fitting_grps[parent].append(conn)
                    grp_labels[conn] = parent

    fitting_grps = list(fitting_grps.values())
    fitting_vec_centers = [[vbc_hash[red_grp] for red_grp in grp] for grp in fitting_grps]
    return fitting_grps, fitting_vec_centers, connections, grp_labels
