"""Write the HDF5 fixtures of the port's HDF5 tests (needs h5py).

    python tests/torch_make_h5_fixture.py [directory]

(default ``tests/data_torch``). Twelve files and a digest list:

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

``storage_types.h5`` holds the types and storage that the host layer
meets in files the JAX package reads through h5py (``types_datasets``):
variable-length strings, compound types of integers (pyuvdata's ``r``/``i``
visibilities), HDF5's n-bit filter and paged extensible-array data blocks.

``vlen_strings.uvh5``, ``vlen_strings.calh5`` and ``vlen_strings.uvflag.h5``
are the repo's h5py-written fixtures (``tests/data``) with every Header
string stored as h5py stores a Python ``str``: a variable-length string.
``hera_int_visdata.uvh5`` is the pyuvdata-layout fixture's data with
``visdata`` a compound of int32 ``r`` and ``i``, as pyuvdata writes HERA's
correlator output. ``nbit_cube_4388x1536.h5`` is the LZF cube under n-bit
then deflate (``flags`` one bit, ``nsamples`` a 16-bit float).

``storage_digests.json`` lists each dataset of the files from
``storage_layouts.h5`` to ``vlen_strings.uvflag.h5`` with its shape, dtype
and the SHA-256 of its values as h5py reads them (C order; a
variable-length string dataset each element's length and bytes), for the
card's machine, which has no h5py.
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
TYPES = "storage_types.h5"
# the repo's h5py-written uvh5, calh5 and UVFlag fixtures, their Header
# strings rewritten as variable-length strings
VLEN = {"golden_golomb_projected.uvh5": "vlen_strings.uvh5",
        "golden_gains.calh5": "vlen_strings.calh5",
        "golden_weights.uvflag.h5": "vlen_strings.uvflag.h5"}
INT_VISDATA = "hera_int_visdata.uvh5"
NBIT_CUBE = "nbit_cube_4388x1536.h5"
DIGESTS = "storage_digests.json"
SEED = 61
MIN_DLY_NS = 2.0 / 0.3
INT_SCALE = 1024.0  # the integer fixture's visibilities: round(INT_SCALE * v)
REPO_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


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


def dtype_name(dt):
    """A dtype's name in a digest: its ``str``; a structured dtype's
    members (name, type, offset) and size spelled out; ``|O`` for objects."""
    if dt.names is not None:
        members = ", ".join(f"{n}: {dtype_name(dt.fields[n][0])} @ {dt.fields[n][1]}"
                            for n in dt.names)
        return f"{{{members}}} x {dt.itemsize}"
    return dt.str if dt.subdtype is None else f"{dt.base.str}{dt.shape}"


def value_bytes(values):
    """The bytes a digest hashes: the values in C order; a structured
    array member after member (never its padding); objects (h5py's
    variable-length strings) each as its length (8 bytes) and its bytes."""
    values = np.asarray(values)
    if values.dtype.names is not None:
        return b"".join(value_bytes(values[n]) for n in values.dtype.names)
    if values.dtype.kind == "O":
        return b"".join(len(v).to_bytes(8, "little") + v for v in values.reshape(-1))
    return np.ascontiguousarray(values).tobytes()


def digest(values, dtype=None):
    """The digest of one dataset's values: shape, dtype and SHA-256. A
    variable-length string dataset (``dtype`` kind O) is hashed under
    ``|O``, its scalar (h5py gives bytes) as one object."""
    values = np.ascontiguousarray(values, dtype=object if dtype is not None
                                  and dtype.kind == "O" else None)  # at least 1-d
    return {"shape": list(values.shape), "dtype": dtype_name(values.dtype),
            "sha256": hashlib.sha256(value_bytes(values)).hexdigest()}


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
                    out[f"{prefix}/{name}"] = digest(node[()], node.dtype)
        walk(f, "")
    return out


def _vlen(value):
    """A fixed-length string value as h5py writes a Python ``str``: a
    variable-length UTF-8 string (an array of them for an array)."""
    if np.ndim(value) == 0:
        return value.decode()
    return np.array([v.decode() for v in value], dtype=h5py.string_dtype())


def write_vlen_strings(path, source):
    """Write ``path``: every dataset of the repo's fixture ``source``
    (``tests/data``), each Header string a variable-length string. The
    uvh5 and UVFlag copies have h5py's default (earliest) file format, the
    calh5 copy the latest."""
    libver = "latest" if source.endswith(".calh5") else "earliest"
    with h5py.File(os.path.join(REPO_DATA, source), "r") as src, \
            h5py.File(path, "w", libver=libver) as f:
        for group in src:
            out = f.create_group(group)
            for name in sorted(src[group]):
                value = src[group][name][()]
                out[name] = _vlen(value) if src[group][name].dtype.kind == "S" else value
    return path


def write_int_visdata(path):
    """Write ``INT_VISDATA``: the pyuvdata-layout fixture's data with
    ``visdata`` stored as pyuvdata's ``data_write_dtype`` stores HERA's
    correlator output, a compound of int32 ``r`` and ``i`` (the
    visibilities times ``INT_SCALE``, rounded), chunked; ``flags`` and
    ``nsamples`` LZF-compressed; Header strings variable-length, as
    pyuvdata writes a ``str``."""
    uvd = make_visdata()
    tmp = path + ".port.uvh5"
    uvd.write_uvh5(tmp, clobber=True, version="1.0")
    try:
        with h5py.File(tmp, "r") as src, h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            for name in sorted(src["Header"]):
                value = src["Header"][name][()]
                hdr[name] = _vlen(value) if src["Header"][name].dtype.kind == "S" else value
            hdr["extra_keywords/comment"] = "integer visibilities, as HERA's correlator writes"
            vis = src["Data"]["visdata"][()] * INT_SCALE
            ints = np.empty(vis.shape, [("r", "<i4"), ("i", "<i4")])
            ints["r"], ints["i"] = np.round(vis.real), np.round(vis.imag)
            data = f.create_group("Data")
            data.create_dataset("visdata", data=ints, chunks=True)
            data.create_dataset("flags", data=src["Data"]["flags"][()], chunks=True,
                                compression="lzf")
            data.create_dataset("nsamples", data=src["Data"]["nsamples"][()], chunks=True,
                                compression="lzf")
    finally:
        os.remove(tmp)
    return path


def _low_level(f, name, ftype, values, chunks, nbit=False, deflate=None, mtype=None):
    """Create dataset ``name`` of file type ``ftype`` (an h5py TypeID) and
    write ``values`` through HDF5's conversion from ``mtype`` (default:
    h5py's type of ``values``); with ``nbit``, n-bit (which h5py's high
    level cannot ask for), then ``deflate`` (a level) where given."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    if nbit:
        dcpl.set_filter(5, 0, ())
    if deflate is not None:
        dcpl.set_deflate(deflate)
    space = h5py.h5s.create_simple(values.shape)
    parent, _, leaf = name.rpartition("/")
    group = f.require_group(parent) if parent else f
    ds = h5py.h5d.create(group.id, leaf.encode(), ftype, space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(values),
             mtype=mtype or h5py.h5t.py_create(values.dtype))


def _int_type(base, precision, offset=0):
    t = base.copy()
    t.set_precision(precision)
    t.set_offset(offset)
    return t


def _float_type(base, fields, precision, bias=None):
    """A float type: its fields (sign, exponent and mantissa positions and
    sizes) set before its precision, as HDF5 requires."""
    t = base.copy()
    t.set_fields(*fields)
    t.set_precision(precision)
    if bias is not None:
        t.set_ebias(bias)
    return t


def types_datasets():
    """{group/name: (values, writer)} of ``storage_types.h5``: ``writer(f,
    name, values)`` writes the dataset. Groups: ``vlen_strings``
    (variable-length strings, UTF-8 and ASCII, scalar and array, in
    compact, contiguous and chunked gzip storage, with elements never
    written); ``compound`` (pyuvdata's int32 and int16 ``r``/``i``
    visibilities over the whole int32 range, big-endian, members in another
    order and padding); ``nbit`` (HDF5's n-bit filter: integers of reduced
    precision at an offset, signed and unsigned, big-endian, 61 bits; floats of
    reduced precision; full precision, stored unchanged; a compound with an
    array member; n-bit then deflate); ``ea_paged`` (one unlimited
    dimension past the 131,060 chunks whose extensible-array data blocks
    are not paged, written sparsely: pages never initialised read as the
    fill value)."""
    rng = np.random.default_rng(SEED)
    strings = np.array(["ANT0", "ANT12", "", "a longer name, UTF-8: \u00e9"], dtype=object)

    def create(**kw):
        return lambda f, name, values: f.create_dataset(name, data=values, **kw)

    def low(ftype, chunks, **kw):
        return lambda f, name, values: _low_level(f, name, ftype, values, chunks, **kw)

    def sparse(where, **kw):
        def write(f, name, values):
            ds = f.create_dataset(name, shape=values.shape, dtype=values.dtype,
                                  maxshape=(None,), chunks=(1,), **kw)
            for i in where:
                ds[i] = values[i]
        return write

    def partial(f, name, values):
        ds = f.create_dataset(name, shape=values.shape, dtype=utf8, chunks=(2,))
        ds[1] = values[1]

    utf8, ascii_ = h5py.string_dtype(), h5py.string_dtype("ascii")
    compact = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    compact.set_layout(h5py.h5d.COMPACT)
    big = np.empty(16, [("r", "<i4"), ("i", "<i4")])
    big["r"] = rng.integers(-2 ** 31, 2 ** 31, 16)
    big["r"][:4] = [-2 ** 31, 2 ** 31 - 1, 2 ** 24 + 1, -(2 ** 24) - 3]
    big["i"] = rng.integers(-2 ** 27, 2 ** 27, 16)
    small = np.empty((6, 5), [("r", "<i2"), ("i", "<i2")])
    small["r"] = rng.integers(-2 ** 15, 2 ** 15, (6, 5))
    small["i"] = rng.integers(-2 ** 15, 2 ** 15, (6, 5))
    padded = np.zeros(7, {"names": ["a", "b"], "formats": ["<u2", "<f8"], "offsets": [0, 8],
                          "itemsize": 24})
    padded["a"], padded["b"] = np.arange(7), rng.standard_normal(7)
    swapped = np.empty(9, [("i", "<i4"), ("r", "<i4")])
    swapped["i"], swapped["r"] = rng.integers(-9999, 9999, 9), rng.integers(-9999, 9999, 9)
    cmp_np = np.dtype({"names": ["a", "b", "c"], "formats": ["<u4", "<f8", ("i1", (2,))],
                       "offsets": [0, 4, 12], "itemsize": 16})
    cmp_h5 = h5py.h5t.create(h5py.h5t.COMPOUND, 16)
    cmp_h5.insert(b"a", 0, _int_type(h5py.h5t.STD_U32LE, 16, 4))
    cmp_h5.insert(b"b", 4, h5py.h5t.IEEE_F64LE)
    cmp_h5.insert(b"c", 12, h5py.h5t.array_create(h5py.h5t.STD_I8LE, (2,)))
    cmp = np.zeros(40, cmp_np)
    cmp["a"], cmp["b"] = rng.integers(0, 2 ** 16, 40), rng.standard_normal(40)
    cmp["c"] = rng.integers(-128, 128, (40, 2))
    u1 = np.zeros(200000, np.uint8)
    u1[[0, 1, 2, 3, 4, 131059, 131061, 150000, 199999]] = [1, 2, 3, 4, 5, 6, 8, 9, 10]
    i4 = np.full(300000, -1, np.int32)
    hits = [*range(131060, 131070), 133108, 133109, *range(262131, 262140), 299999]
    i4[hits] = rng.integers(0, 1000, len(hits))
    return {
        "vlen_strings/scalar_utf8": (np.array("HERA", dtype=object), create(dtype=utf8)),
        "vlen_strings/scalar_ascii": (np.array(b"calh5", dtype=object), create(dtype=ascii_)),
        "vlen_strings/empty": (np.array("", dtype=object), create(dtype=utf8)),
        "vlen_strings/array_utf8": (strings, create(dtype=utf8)),
        "vlen_strings/array_ascii": (np.array([b"x", b"yy", b"zzz"], dtype=object),
                                     create(dtype=ascii_)),
        "vlen_strings/chunked_gzip": (np.array(list(strings) * 5, dtype=object),
                                      create(dtype=utf8, chunks=(3,), compression="gzip")),
        "vlen_strings/compact": (strings, create(dtype=utf8, dcpl=compact)),
        "vlen_strings/never_written": (np.array(["", "one", "", ""], dtype=object), partial),
        "compound/int32_ri": (big, create()),
        "compound/int32_ri_big_endian": (big.astype([("r", ">i4"), ("i", ">i4")]), create()),
        "compound/int16_ri_chunked": (small, create(chunks=(4, 3), compression="gzip")),
        "compound/int32_ir": (swapped, create()),
        "compound/padded": (padded, create()),
        "nbit/u32_precision16_offset4": (
            rng.integers(0, 2 ** 16, (70,)).astype(np.uint32),
            low(_int_type(h5py.h5t.STD_U32LE, 16, 4), (32,), nbit=True)),
        "nbit/i32_precision12_offset4": (
            rng.integers(-2 ** 11, 2 ** 11, (9, 8)).astype(np.int32),
            low(_int_type(h5py.h5t.STD_I32LE, 12, 4), (4, 8), nbit=True)),
        "nbit/i16_precision10_offset3_big_endian": (
            rng.integers(-2 ** 9, 2 ** 9, (50,)).astype(">i2"),
            low(_int_type(h5py.h5t.STD_I16BE, 10, 3), (25,), nbit=True)),
        "nbit/f32_mantissa15": (  # a float24 in the low three bytes of four; signed zeros,
            # subnormals, infinities and NaN too
            np.concatenate([rng.standard_normal(45), [0.0, -0.0, 1e-40, -3e-39, 2e-45, np.inf,
                                                      -np.inf, np.nan, 3e38]]).astype(np.float32),
            low(_float_type(h5py.h5t.IEEE_F32LE, (23, 15, 8, 0, 15), 24), (15,), nbit=True)),
        "nbit/f64_as_float32_big_endian": (  # read as float64, as h5py reads it
            rng.standard_normal(30),
            low(_float_type(h5py.h5t.IEEE_F64BE, (31, 23, 8, 0, 23), 32, 127), (30,),
                nbit=True)),
        "nbit/i64_precision61_offset2": (  # values that straddle 8 bytes of the stream
            rng.integers(-2 ** 60, 2 ** 60, (33,)).astype(np.int64),
            low(_int_type(h5py.h5t.STD_I64LE, 61, 2), (33,), nbit=True)),
        "nbit/i32_full_precision": (rng.integers(-2 ** 31, 2 ** 31, 20).astype(np.int32),
                                    low(h5py.h5t.STD_I32LE, (8,), nbit=True)),
        "nbit/compound": (cmp, low(cmp_h5, (16,), nbit=True, mtype=h5py.h5t.py_create(cmp_np))),
        "nbit/u8_precision3_deflate": (
            (rng.random((60, 50)) * 8).astype(np.uint8),
            low(_int_type(h5py.h5t.STD_U8LE, 3), (20, 25), nbit=True, deflate=4)),
        "ea_paged/u8_fill7": (np.where(u1 > 0, u1, 7).astype(np.uint8),
                              sparse(np.flatnonzero(u1), fillvalue=7)),
        "ea_paged/i32_gzip": (i4, sparse(hits, fillvalue=-1, compression="gzip")),
    }


def write_types(path):
    """Write ``storage_types.h5`` to ``path``."""
    with h5py.File(path, "w", libver="latest") as f:
        for name, (values, writer) in types_datasets().items():
            writer(f, name, values)
    return path


def write_nbit_cube(path):
    """Write the n-bit twin of the LZF cube: ``flags`` as uint8 of
    precision 1, ``nsamples`` as a float of 16 bits (bfloat16's fields in
    the low half of four bytes: h5py reads float32), each under n-bit then
    deflate, in the LZF cube's chunks."""
    flags, nsamples = lzf_cube_arrays()
    bf16 = _float_type(h5py.h5t.IEEE_F32LE, (15, 7, 8, 0, 7), 16)
    with h5py.File(path, "w") as f:
        _low_level(f, "Data/flags", _int_type(h5py.h5t.STD_U8LE, 1), flags.astype(np.uint8),
                   (275, 96, 1), nbit=True, deflate=4)
        _low_level(f, "Data/nsamples", bf16, nsamples, (138, 96, 1), nbit=True, deflate=4)
    return path


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
    paths += [write_types(os.path.join(directory, TYPES)),
              write_int_visdata(os.path.join(directory, INT_VISDATA))]
    paths += [write_vlen_strings(os.path.join(directory, name), source)
              for source, name in VLEN.items()]
    digests = {os.path.basename(p): file_digests(p) for p in paths[3:]}
    paths.append(write_nbit_cube(os.path.join(directory, NBIT_CUBE)))
    with open(os.path.join(directory, DIGESTS), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return paths + [os.path.join(directory, DIGESTS)]


if __name__ == "__main__":
    for p in write(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR):
        print(f"wrote {p}")
