"""Calibration-gain container (UVCal equivalent) with HDF5 I/O.

From-scratch replacement for the subset of ``pyuvdata.UVCal`` the reference
uses (cal_utils.py:7-59, calibration.py:369-399, 798-825). Gains are stored
as a dense complex array with the pyuvdata axis convention:

    gain_array: (Nants_data, Nspws=1, Nfreqs, Ntimes, Njones)

The native on-disk format is "calh5": a simple HDF5 Header/Data layout
mirroring the uvh5 pattern. write_calfits/from_calfits (io.calfits)
implement pyuvdata's calfits gain-type layout so gains interoperate with
the HERA toolchain (reference writes via UVCal.write_calfits,
calibration.py:1810).
"""

from __future__ import annotations

import copy as _copy

import h5py
import numpy as np

from .polarizations import jstr2num

_SCALARS = (
    "Nants_data",
    "Nants_telescope",
    "Nfreqs",
    "Njones",
    "Ntimes",
    "Nspws",
    "latitude",
    "longitude",
    "altitude",
    "integration_time",
    "channel_width",
)

_ARRAYS = (
    "ant_array",
    "antenna_numbers",
    "antenna_positions",
    "freq_array",
    "jones_array",
    "time_array",
    "lst_array",
    "spw_array",
    "time_range",
)

_STRINGS = (
    "telescope_name",
    "gain_convention",
    "cal_style",
    "cal_type",
    "x_orientation",
    "history",
)


class CalData:
    """Per-antenna complex gain solutions."""

    def __init__(self, **kwargs):
        self.telescope_name = "unknown"
        self.gain_convention = "divide"
        self.cal_style = "redundant"
        self.cal_type = "gain"
        self.x_orientation = None
        self.history = ""
        self.latitude = 0.0
        self.longitude = 0.0
        self.altitude = 0.0
        self.integration_time = 0.0
        self.channel_width = 0.0
        self.spw_array = np.array([0])
        self.ant_array = None
        self.antenna_numbers = None
        self.antenna_names = None
        self.antenna_positions = None
        self.freq_array = None
        self.jones_array = None
        self.time_array = None
        self.lst_array = None
        self.time_range = None
        self.gain_array = None
        self.flag_array = None
        self.quality_array = None
        for key, val in kwargs.items():
            setattr(self, key, val)
        if self.gain_array is not None:
            self._sync_metadata()

    def _sync_metadata(self):
        self.Nants_data = self.gain_array.shape[0]
        self.Nspws = self.gain_array.shape[1]
        self.Nfreqs = self.gain_array.shape[2]
        self.Ntimes = self.gain_array.shape[3]
        self.Njones = self.gain_array.shape[4]
        if self.antenna_numbers is not None:
            self.Nants_telescope = len(self.antenna_numbers)
        else:
            self.Nants_telescope = self.Nants_data

    def copy(self):
        return _copy.deepcopy(self)

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @classmethod
    def blank_from_visdata(cls, visdata):
        """Unity-gain, unflagged CalData matching a VisData.

        Reference parity: cal_utils.blank_uvcal_from_uvdata
        (cal_utils.py:7-59): gain_convention="divide", cal_style="redundant",
        ant_array = union of data antennas, times = unique data times."""
        obj = cls()
        obj.telescope_name = visdata.telescope_name
        obj.latitude = visdata.latitude
        obj.longitude = visdata.longitude
        obj.altitude = visdata.altitude
        obj.ant_array = np.asarray(
            sorted(set(visdata.ant_1_array.tolist()) | set(visdata.ant_2_array.tolist()))
        )
        obj.antenna_numbers = np.asarray(visdata.antenna_numbers)
        obj.antenna_names = list(visdata.antenna_names) if visdata.antenna_names else None
        obj.antenna_positions = np.asarray(visdata.antenna_positions)
        obj.freq_array = np.asarray(visdata.freq_array)
        obj.jones_array = np.asarray(visdata.polarization_array)
        # lst per UNIQUE TIME, aligned index-for-index with time_array —
        # np.unique on the LSTs themselves breaks the pairing whenever LSTs
        # repeat (simulated data) or wrap through 0 (real data)
        obj.time_array, first_rows = np.unique(
            visdata.time_array, return_index=True
        )
        obj.lst_array = np.asarray(visdata.lst_array)[first_rows]
        obj.integration_time = float(np.mean(visdata.integration_time))
        obj.x_orientation = visdata.x_orientation
        nants = len(obj.ant_array)
        shape = (nants, 1, visdata.Nfreqs, len(obj.time_array), visdata.Npols)
        obj.flag_array = np.zeros(shape, dtype=bool)
        obj.quality_array = np.zeros(shape, dtype=np.float64)
        obj.gain_array = np.ones(shape, dtype=np.complex128)
        obj.time_range = np.array(
            [
                obj.time_array.min() - obj.integration_time / 2.0,
                obj.time_array.max() + obj.integration_time / 2.0,
            ]
        )
        obj.channel_width = float(np.median(np.diff(obj.freq_array[0])))
        obj._sync_metadata()
        return obj

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #
    def _jones_ind(self, jones):
        jnum = jstr2num(jones, x_orientation=self.x_orientation)
        return int(np.nonzero(self.jones_array == jnum)[0][0])

    def _ant_ind(self, ant):
        return int(np.nonzero(self.ant_array == ant)[0][0])

    def get_gains(self, ant, jones=None):
        """Gains (Nfreqs, Ntimes) for an antenna / jones term."""
        if jones is None:
            ant, jones = ant
        return self.gain_array[self._ant_ind(ant), 0, :, :, self._jones_ind(jones)]

    def get_flags(self, ant, jones=None):
        if jones is None:
            ant, jones = ant
        return self.flag_array[self._ant_ind(ant), 0, :, :, self._jones_ind(jones)]

    # ------------------------------------------------------------------ #
    # selection / concat over times
    # ------------------------------------------------------------------ #
    def select(self, times=None, inplace=True):
        obj = self if inplace else self.copy()
        if times is not None:
            mask = np.zeros(obj.Ntimes, dtype=bool)
            for t in np.atleast_1d(times):
                mask |= np.isclose(obj.time_array, t, rtol=0.0, atol=1e-7)
            idx = np.nonzero(mask)[0]
            obj.time_array = obj.time_array[idx]
            if obj.lst_array is not None and len(obj.lst_array) == len(mask):
                obj.lst_array = obj.lst_array[idx]
            obj.gain_array = obj.gain_array[:, :, :, idx]
            obj.flag_array = obj.flag_array[:, :, :, idx]
            obj.quality_array = obj.quality_array[:, :, :, idx]
            obj._sync_metadata()
        if not inplace:
            return obj
        return None

    def __add__(self, other):
        out = self.copy()
        order = np.argsort(np.concatenate([self.time_array, other.time_array]))
        out.time_array = np.concatenate([self.time_array, other.time_array])[order]
        if self.lst_array is not None and other.lst_array is not None:
            out.lst_array = np.concatenate([self.lst_array, other.lst_array])[order]
        out.gain_array = np.concatenate([self.gain_array, other.gain_array], axis=3)[:, :, :, order]
        out.flag_array = np.concatenate([self.flag_array, other.flag_array], axis=3)[:, :, :, order]
        out.quality_array = np.concatenate([self.quality_array, other.quality_array], axis=3)[
            :, :, :, order
        ]
        out._sync_metadata()
        return out

    # ------------------------------------------------------------------ #
    # HDF5 I/O (native "calh5" layout)
    # ------------------------------------------------------------------ #
    def write_calh5(self, path, clobber=False):
        import os

        if os.path.exists(path) and not clobber:
            raise IOError(f"{path} exists and clobber=False")
        with h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            self._sync_metadata()
            for name in _SCALARS:
                hdr[name] = getattr(self, name)
            for name in _ARRAYS:
                val = getattr(self, name)
                if val is not None:
                    hdr[name] = np.asarray(val)
            for name in _STRINGS:
                val = getattr(self, name)
                if val is not None:
                    hdr[name] = np.bytes_(str(val))
            if self.antenna_names is not None:
                hdr["antenna_names"] = np.asarray([np.bytes_(a) for a in self.antenna_names])
            data = f.create_group("Data")
            data.create_dataset("gains", data=self.gain_array.astype(np.complex128))
            data.create_dataset("flags", data=self.flag_array.astype(bool))
            data.create_dataset("qualities", data=self.quality_array.astype(np.float64))

    @classmethod
    def from_calh5(cls, path):
        obj = cls()
        with h5py.File(path, "r") as f:
            hdr = f["Header"]
            for name in _SCALARS:
                if name in hdr:
                    setattr(obj, name, np.asarray(hdr[name][()]).item())
            for name in _ARRAYS:
                if name in hdr:
                    setattr(obj, name, np.asarray(hdr[name][()]))
            for name in _STRINGS:
                if name in hdr:
                    val = hdr[name][()]
                    setattr(obj, name, val.decode("utf-8") if isinstance(val, bytes) else val)
            if "antenna_names" in hdr:
                obj.antenna_names = [
                    a.decode("utf-8") if isinstance(a, bytes) else a
                    for a in hdr["antenna_names"][()]
                ]
            data = f["Data"]
            obj.gain_array = np.asarray(data["gains"][()])
            obj.flag_array = np.asarray(data["flags"][()])
            obj.quality_array = np.asarray(data["qualities"][()])
        obj._sync_metadata()
        return obj

    def write_calfits(self, path, clobber=False):
        from .calfits import write_calfits

        write_calfits(self, path, clobber=clobber)

    @classmethod
    def from_calfits(cls, path):
        from .calfits import read_calfits

        return read_calfits(cls, path)

    # reference-compatible alias (UVCal.read_calfits)
    def read_calfits(self, path):
        other = CalData.from_calfits(path)
        self.__dict__.update(other.__dict__)
        return self
