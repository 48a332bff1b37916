"""Write the HDF5 fixtures of the port's HDF5 tests (needs h5py).

    python tests/torch_make_h5_fixture.py [directory]

(default ``tests/data_torch``). Six files and a digest list:

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
(``chip_smoke.py`` phase 6). ``szip_cube_4388x1536.h5`` holds the same
cubes under szip with NN preprocessing (32 pixels a block), to time the
szip decoder at that size. (HDF5 applies szip to integers and floats
only, so ``visdata``, a complex compound, is never szip-compressed.)

``storage_layouts.h5`` holds small datasets (seeded data) in the storage
h5py 3.14 / HDF5 1.14 writes for the latest file format and for its
built-in filters, one group each: ``extensible_array`` (one unlimited
dimension: enough chunks for the index's secondary blocks, unfiltered and
gzip-filtered, the unlimited dimension first and last, edge chunks and
unallocated chunks); ``btree2`` (two or more unlimited dimensions: a
B-tree with internal nodes, unfiltered and filtered); ``szip`` (NN and EC
coding of 8-, 16-, 32- and 64-bit data, a scanline that is not a whole
number of blocks, an all-zero chunk, chunks szip could not shrink and
stored raw); ``scaleoffset`` (integers with the minimum bits found or
given, signed, big-endian, with and without a fill value; floats by
D-scale, with a fill value and unallocated chunks).

``unlimited_szip.uvh5`` and ``unlimited2_szip.uvh5`` are the
pyuvdata-layout fixture's data with the ``Data`` datasets stored so:
``visdata`` chunked under an extensible array (``Nblts`` unlimited) with
gzip, ``flags`` szip (NN), ``nsamples`` scale-offset; and ``visdata``
under a v2 B-tree (every axis unlimited), ``flags`` szip (EC),
``nsamples`` szip (NN).

``storage_digests.json`` lists each dataset of those three files with its
shape, dtype and the SHA-256 of its values as h5py reads them (C order),
for the card's machine, which has no h5py.
"""

import hashlib
import json
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from calamity_tpu_torch import cal_utils, models, simulate  # noqa: E402

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch")
FIXTURE = "pyuvdata_layout.uvh5"
LZF_CUBE = "lzf_cube_4388x1536.h5"
SZIP_CUBE = "szip_cube_4388x1536.h5"
STORAGE = "storage_layouts.h5"
UVH5_UNLIMITED = ("unlimited_szip.uvh5", "unlimited2_szip.uvh5")
DIGESTS = "storage_digests.json"
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


def write_lzf_cube(path, **filters):
    """Write the LZF cube to ``path`` (or, with h5py's ``filters``, its
    twin under them)."""
    flags, nsamples = lzf_cube_arrays()
    filters = filters or dict(compression="lzf")
    with h5py.File(path, "w") as f:
        data = f.create_group("Data")
        data.create_dataset("flags", data=flags, chunks=True, **filters)
        data.create_dataset("nsamples", data=nsamples, chunks=True, **filters)
    return path


def write_szip_cube(path):
    """Write the szip twin of the LZF cube to ``path``."""
    return write_lzf_cube(path, compression="szip", compression_opts=("nn", 32))


def storage_datasets():
    """{group/name: (values, h5py create_dataset keywords)} of
    ``storage_layouts.h5``; ``write`` is a slice that alone is written
    (the rest stays unallocated)."""
    rng = np.random.default_rng(SEED)
    walk = np.cumsum(rng.integers(-3, 4, (48, 64)), axis=1).astype(np.int16)
    smooth = np.sin(np.linspace(0, 20, 40 * 50)).astype(np.float32).reshape(40, 50)
    out = {
        # 300 chunks: past the 244 the index block and its direct data blocks hold
        "extensible_array/rows": (rng.integers(0, 1000, (300, 7)).astype(np.int16),
                                  dict(chunks=(1, 7), maxshape=(None, 7))),
        "extensible_array/rows_gzip": (rng.standard_normal((613, 3)),
                                       dict(chunks=(1, 2), maxshape=(None, 3),
                                            compression="gzip", shuffle=True)),
        "extensible_array/last_axis": (rng.integers(0, 50, (5, 300)).astype(np.int32),
                                       dict(chunks=(5, 1), maxshape=(5, None))),
        "extensible_array/edges_lzf": (rng.standard_normal((37, 23)).astype(np.float32),
                                       dict(chunks=(8, 5), maxshape=(37, None),
                                            compression="lzf")),
        "extensible_array/unallocated": (np.arange(700, dtype=np.int32),
                                         dict(chunks=(1,), maxshape=(None,), fillvalue=-7,
                                              write=slice(3, 650))),
        # 510 records of 24 bytes: leaves under an internal node
        "btree2/grid": (rng.standard_normal((100, 90)).astype(np.float32),
                        dict(chunks=(3, 2), maxshape=(None, None), fillvalue=2.5,
                             write=(slice(0, 50), slice(0, 60)))),
        "btree2/grid_gzip": (rng.integers(0, 9, (40, 40)).astype(np.int16),
                             dict(chunks=(2, 2), maxshape=(None, None), compression="gzip",
                                  fletcher32=True)),
        "btree2/cube": (rng.integers(0, 9, (12, 13, 14)).astype(np.int32),
                        dict(chunks=(2, 3, 2), maxshape=(None, 13, None))),
        "szip/nn_int32_scanline_23": (rng.integers(0, 100, (40, 23)).astype(np.int32),
                                      dict(chunks=(40, 23), compression="szip",
                                           compression_opts=("nn", 8))),
        "szip/ec_int32": (rng.integers(0, 100, (40, 24)).astype(np.int32),
                          dict(chunks=(40, 24), compression="szip",
                               compression_opts=("ec", 8))),
        "szip/nn_uint8": (rng.integers(0, 5, (64, 32)).astype(np.uint8),
                          dict(chunks=(64, 32), compression="szip",
                               compression_opts=("nn", 16))),
        "szip/nn_int16": (walk, dict(chunks=(24, 64), compression="szip",
                                     compression_opts=("nn", 32))),
        "szip/nn_float32": (smooth, dict(chunks=(40, 50), compression="szip",
                                         compression_opts=("nn", 8))),
        "szip/ec_float64_smooth": (smooth.astype(np.float64)[:30, :20],
                                   dict(chunks=(10, 20), compression="szip",
                                        compression_opts=("ec", 8))),
        "szip/ec_float64_stored_raw": (rng.standard_normal((30, 20)),
                                       dict(chunks=(10, 20), compression="szip",
                                            compression_opts=("ec", 8))),
        "szip/nn_zeros": (np.zeros((64, 64), np.int32),
                          dict(chunks=(64, 64), compression="szip",
                               compression_opts=("nn", 8))),
        "scaleoffset/int32_minbits_found": (rng.integers(-50, 100, (40, 23)).astype(np.int32),
                                            dict(chunks=(16, 23), scaleoffset=0)),
        "scaleoffset/uint16_minbits_4": (rng.integers(1000, 1015, (40, 23)).astype(np.uint16),
                                         dict(chunks=(16, 23), scaleoffset=4)),
        "scaleoffset/int64": (rng.integers(-2 ** 40, 2 ** 40, (30,)).astype(np.int64),
                              dict(chunks=(10,), scaleoffset=0)),
        "scaleoffset/int8_one_value": (np.full((20,), -3, np.int8),
                                       dict(chunks=(10,), scaleoffset=0)),
        "scaleoffset/uint16_big_endian": (rng.integers(0, 200, (50,)).astype(">u2"),
                                          dict(chunks=(25,), scaleoffset=0)),
        "scaleoffset/float32_d2": (rng.standard_normal((40, 23)).astype(np.float32),
                                   dict(chunks=(16, 23), scaleoffset=2)),
        "scaleoffset/float64_d3": (rng.standard_normal((40, 23)),
                                   dict(chunks=(16, 23), scaleoffset=3)),
    }
    hit = rng.integers(-50, 100, (40, 23)).astype(np.int32)
    hit[::3, ::2] = 7  # values equal to the fill value
    out["scaleoffset/int32_fill"] = (hit, dict(chunks=(16, 23), scaleoffset=0, fillvalue=7))
    fhit = rng.standard_normal((40, 23)).astype(np.float32)
    fhit[::3, ::2] = -1.5
    out["scaleoffset/float32_fill"] = (fhit, dict(chunks=(16, 23), scaleoffset=2,
                                                  fillvalue=-1.5))
    out["scaleoffset/float32_unallocated"] = (
        rng.standard_normal((40, 23)).astype(np.float32),
        dict(chunks=(16, 23), scaleoffset=2, fillvalue=9.25, write=slice(0, 10)))
    return out


def write_storage(path):
    """Write ``storage_layouts.h5`` to ``path``."""
    with h5py.File(path, "w", libver="latest") as f:
        for name, (values, kw) in storage_datasets().items():
            kw = dict(kw)
            part = kw.pop("write", None)
            if part is None:
                f.create_dataset(name, data=values, **kw)
            else:
                ds = f.create_dataset(name, shape=values.shape, dtype=values.dtype, **kw)
                ds[part] = values[part]
    return path


def write_unlimited_uvh5(path, which):
    """Write ``UVH5_UNLIMITED[which]``: the pyuvdata-layout fixture's data
    with its ``Data`` datasets under an extensible-array index (0) or a v2
    B-tree (1), szip and scale-offset filters."""
    uvd = make_visdata()
    tmp = path + ".port.uvh5"
    uvd.write_uvh5(tmp, clobber=True, version="1.0")
    storage = ({"visdata": dict(chunks=(1, 40, 1), maxshape=(None, 160, 1),
                                compression="gzip"),
                "flags": dict(chunks=(6, 160, 1), compression="szip",
                              compression_opts=("nn", 8)),
                "nsamples": dict(chunks=(6, 160, 1), scaleoffset=2)},
               {"visdata": dict(chunks=(4, 40, 1), maxshape=(None, None, None)),
                "flags": dict(chunks=(6, 160, 1), compression="szip",
                              compression_opts=("ec", 8)),
                "nsamples": dict(chunks=(6, 160, 1), compression="szip",
                                 compression_opts=("nn", 8))})[which]
    try:
        with h5py.File(tmp, "r") as src, h5py.File(path, "w", libver="latest") as f:
            hdr = f.create_group("Header")
            for name in sorted(src["Header"]):
                hdr[name] = src["Header"][name][()]
            data = f.create_group("Data")
            for name, kw in storage.items():
                data.create_dataset(name, data=src["Data"][name][()], **kw)
    finally:
        os.remove(tmp)
    return path


def digest(values):
    """The digest of one dataset's values: shape, dtype and SHA-256."""
    values = np.ascontiguousarray(values)
    return {"shape": list(values.shape), "dtype": values.dtype.str,
            "sha256": hashlib.sha256(values.tobytes()).hexdigest()}


def file_digests(path, opener=h5py.File):
    """{dataset path: digest} of every dataset of an HDF5 file."""
    out = {}
    with opener(path, "r") as f:
        def walk(grp, prefix):
            for name in grp.keys():
                node = grp[name]
                if hasattr(node, "keys"):
                    walk(node, f"{prefix}/{name}")
                else:
                    out[f"{prefix}/{name}"] = digest(node[()])
        walk(f, "")
    return out


def write(directory=DEFAULT_DIR):
    """Write every fixture and the digest list into ``directory`` (made if
    missing)."""
    os.makedirs(directory, exist_ok=True)
    paths = [write_fixture(os.path.join(directory, FIXTURE)),
             write_lzf_cube(os.path.join(directory, LZF_CUBE)),
             write_szip_cube(os.path.join(directory, SZIP_CUBE)),
             write_storage(os.path.join(directory, STORAGE))]
    paths += [write_unlimited_uvh5(os.path.join(directory, name), k)
              for k, name in enumerate(UVH5_UNLIMITED)]
    digests = {os.path.basename(p): file_digests(p) for p in paths[3:]}
    with open(os.path.join(directory, DIGESTS), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return paths + [os.path.join(directory, DIGESTS)]


if __name__ == "__main__":
    for p in write(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR):
        print(f"wrote {p}")
