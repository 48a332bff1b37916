"""Write the HDF5 fixtures of the port's HDF5 tests (needs h5py).

    python tests/torch_make_h5_fixture.py [directory]

(default ``tests/data_torch``). Two files:

``pyuvdata_layout.uvh5`` has the
layout that pyuvdata's ``UVData.write_uvh5`` gives by default: uvh5 1.0 (no
spw axis on the Data datasets, a 1-D ``freq_array``, a per-channel
``channel_width``), ``visdata`` chunked, ``flags`` and ``nsamples`` chunked
and compressed with LZF (h5py's filter 32000), an ``extra_keywords`` group
holding a variable-length string, and attributes on ``Header``. It is
written by h5py with its default (earliest) file format: a version-0
superblock, version-1 object headers and symbol-table groups.

Its data: a 6-antenna Golomb array (cross baselines), 160 channels of 100
kHz from 100 MHz, 2 times, one polarization; the sky projected onto each
baseline's DPSS basis (min_dly = offset = 2 / 0.3 ns), then corrupted by 3%
complex gain errors; channel 10 of every baseline flagged. Made from a
seed with the port's host layer (``calamity_tpu_torch``), so the same
script writes the same values.

``lzf_cube_4388x1536.h5`` holds the ``flags`` and ``nsamples`` cubes of
the HERA core's 4388 baselines x 1536 channels (one polarization) under
``Data``, chunked and LZF-compressed by h5py's automatic chunking, as
pyuvdata writes them: 5% of the channels flagged on every baseline (seeded),
every nsample 1. It times the pure-Python LZF decoder at that size
(``chip_smoke.py`` phase 6).
"""

import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from calamity_tpu_torch import cal_utils, models, simulate  # noqa: E402

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch")
FIXTURE = "pyuvdata_layout.uvh5"
LZF_CUBE = "lzf_cube_4388x1536.h5"
SEED = 61
MIN_DLY_NS = 2.0 / 0.3


def make_visdata():
    """The corrupted VisData behind the fixture."""
    uvd = simulate.make_golomb_array(nants=6, nfreqs=160, ntimes=2, seed=SEED)
    uvd.select(bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]], inplace=True)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS)
    for key, mat in comps.items():
        rows, conj = uvd._bl_time_rows(*key[0][0])
        d = uvd.data_array[rows, 0, :, 0]
        d = np.conj(d) if conj else d
        proj = (d @ mat) @ mat.T
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    rng = np.random.default_rng(SEED)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape))
    out = cal_utils.apply_gains(uvd, truth, inverse=True)
    out.flag_array[:, :, 10, :] = True
    out.history = "pyuvdata-layout fixture: tests/torch_make_h5_fixture.py"
    return out


def write_fixture(path):
    """Write the pyuvdata-layout fixture to ``path``."""
    uvd = make_visdata()
    tmp = path + ".port.uvh5"
    uvd.write_uvh5(tmp, clobber=True, version="1.0")  # the port's writer, through h5py
    try:
        with h5py.File(tmp, "r") as src, h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            for name in sorted(src["Header"]):
                hdr[name] = src["Header"][name][()]
            hdr.attrs["writer"] = np.bytes_("tests/torch_make_h5_fixture.py")
            hdr.attrs["Nblts"] = uvd.Nblts
            extra = hdr.create_group("extra_keywords")
            extra["comment"] = "a variable-length string, as pyuvdata writes one"
            extra["obsid"] = 1234567890
            data = f.create_group("Data")
            data.create_dataset("visdata", data=src["Data"]["visdata"][()], chunks=True)
            data.create_dataset("flags", data=src["Data"]["flags"][()], chunks=True,
                                compression="lzf")
            data.create_dataset("nsamples", data=src["Data"]["nsamples"][()], chunks=True,
                                compression="lzf")
    finally:
        os.remove(tmp)
    return path


def lzf_cube_arrays(nbls=4388, nfreqs=1536):
    """(flags, nsamples) of the LZF cube, each (nbls, nfreqs, 1)."""
    rng = np.random.default_rng(SEED)
    flags = np.zeros((nbls, nfreqs, 1), bool)
    flags[:, rng.random(nfreqs) < 0.05, :] = True
    return flags, np.ones((nbls, nfreqs, 1), np.float32)


def write_lzf_cube(path):
    """Write the LZF cube to ``path``."""
    flags, nsamples = lzf_cube_arrays()
    with h5py.File(path, "w") as f:
        data = f.create_group("Data")
        data.create_dataset("flags", data=flags, chunks=True, compression="lzf")
        data.create_dataset("nsamples", data=nsamples, chunks=True, compression="lzf")
    return path


def write(directory=DEFAULT_DIR):
    """Write both fixtures into ``directory`` (made if missing)."""
    os.makedirs(directory, exist_ok=True)
    return (write_fixture(os.path.join(directory, FIXTURE)),
            write_lzf_cube(os.path.join(directory, LZF_CUBE)))


if __name__ == "__main__":
    for p in write(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR):
        print(f"wrote {p}")
