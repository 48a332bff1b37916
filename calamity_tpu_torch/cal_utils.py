"""Gain application and blank-calibration construction.

Reference parity: calamity/cal_utils.py. The reference applies gains with a
per-(pol, antpair, time) Python loop (cal_utils.py:62-105); here the whole
operation is one vectorized fancy-index per polarization.
"""

from __future__ import annotations

import numpy as np

from .io.caldata import CalData
from .io.polarizations import polstr2num


def blank_uvcal_from_uvdata(uvdata):
    """Unity-gain unflagged CalData matching a VisData
    (reference cal_utils.py:7-59)."""
    return CalData.blank_from_visdata(uvdata)


def _gain_time_blocks(uvdata, gains):
    """(a0, a1, tidx): per-blt gain antenna indices and gain-time index.

    Matches each blt time to a gain time at atol 1e-7 like the reference;
    unique times are matched once and broadcast — a per-blt isclose scan is
    millions of Python iterations at full-HERA blt counts."""
    ant_index = {int(a): i for i, a in enumerate(gains.ant_array)}
    a0 = np.array([ant_index[int(a)] for a in uvdata.ant_1_array])
    a1 = np.array([ant_index[int(a)] for a in uvdata.ant_2_array])
    utimes, uinv = np.unique(uvdata.time_array, return_inverse=True)
    umatch = np.zeros(len(utimes), dtype=np.int64)
    for i, t in enumerate(utimes):
        matches = np.nonzero(np.isclose(gains.time_array, t, rtol=0.0, atol=1e-7))[0]
        if len(matches) == 0:
            raise ValueError(f"no gain solution for time {t}")
        umatch[i] = matches[0]
    return a0, a1, umatch[uinv]


def _rows_index(rows):
    """Basic slice for contiguous blt-row blocks (the standard time-sorted
    table): in-place ufuncs on a basic slice update the buffer directly,
    where fancy indexing forces a gather + full-block scatter copy per
    operation — several extra full-cube passes at full-HERA scale."""
    if len(rows) and int(rows[-1]) - int(rows[0]) + 1 == len(rows):
        return slice(int(rows[0]), int(rows[-1]) + 1)
    return rows


def apply_gains(uvdata, gains, inverse=False, inplace=False):
    """Calibrate (divide by g_i conj(g_j)) or corrupt (inverse=True, multiply).

    Gain flags are OR'd into the output data flags
    (reference cal_utils.py:62-105). ``inplace=True`` mutates ``uvdata``
    and returns it instead of copying — a full-HERA many-times VisData is
    ~10 GiB of host data, so every avoidable copy matters in the driver's
    write-back (the round-3 endurance run OOM'd the host there)."""
    calibrated = uvdata if inplace else uvdata.copy()
    # identity fast path: unity unflagged gains (the blind-self-cal
    # default — gains=None initializes unity) change nothing; x/1 == x*1
    # == x bit-exactly and the flag OR is a no-op. Skips several full-cube
    # host passes (~5 min at full-HERA many-times scale).
    if not np.any(gains.flag_array) and np.all(gains.gain_array == 1.0):
        return calibrated
    a0, a1, tidx = _gain_time_blocks(uvdata, gains)

    for pnum, pol in enumerate(uvdata.get_pols()):
        gp = int(
            np.nonzero(
                gains.jones_array == polstr2num(pol, x_orientation=gains.x_orientation)
            )[0][0]
        )
        g = gains.gain_array[:, 0, :, :, gp]  # (nants, nfreqs, ntimes)
        gf = gains.flag_array[:, 0, :, :, gp]
        # one gain time per block of blts: gather and multiply per block so
        # the transient is (block nbls, nfreqs), not (nblts, nfreqs) — at
        # full-HERA many-times scale the all-blts gather materializes
        # several copies of a ~10 GiB complex cube
        for ti in np.unique(tidx):
            rows = np.nonzero(tidx == ti)[0]
            r = _rows_index(rows)
            gg = g[a0[rows], :, ti] * np.conj(g[a1[rows], :, ti])
            if inverse:
                calibrated.data_array[r, 0, :, pnum] *= gg
            else:
                calibrated.data_array[r, 0, :, pnum] /= gg
            calibrated.flag_array[r, 0, :, pnum] |= (
                gf[a0[rows], :, ti] | gf[a1[rows], :, ti]
            )
    return calibrated


def subtract_model_with_gains(resid, model, gains):
    """``resid -= g_i conj(g_j) · model`` without a full VisData copy.

    Equivalent to ``apply_gains(model, gains, inverse=True)`` followed by
    subtraction and zeroing the residual where the gain-corrupted model is
    flagged (the reference's residual formation, calibration.py:1322-1327)
    — but the corrupted model exists only one (time, pol) block at a time.
    ``model`` is left untouched (the ``correct_model=True`` output keeps
    the deconvolved model). Neither object's flags are modified."""
    a0, a1, tidx = _gain_time_blocks(model, gains)
    for pnum, pol in enumerate(model.get_pols()):
        gp = int(
            np.nonzero(
                gains.jones_array == polstr2num(pol, x_orientation=gains.x_orientation)
            )[0][0]
        )
        g = gains.gain_array[:, 0, :, :, gp]  # (nants, nfreqs, ntimes)
        gf = gains.flag_array[:, 0, :, :, gp]
        for ti in np.unique(tidx):
            rows = np.nonzero(tidx == ti)[0]
            r = _rows_index(rows)
            gg = g[a0[rows], :, ti] * np.conj(g[a1[rows], :, ti])
            blk = resid.data_array[r, 0, :, pnum]
            blk -= model.data_array[r, 0, :, pnum] * gg
            flagged = (
                model.flag_array[r, 0, :, pnum]
                | gf[a0[rows], :, ti]
                | gf[a1[rows], :, ti]
            )
            blk[flagged] = 0.0
            if not isinstance(r, slice):
                # fancy-index read made `blk` a copy; write it back
                resid.data_array[r, 0, :, pnum] = blk
    return resid
