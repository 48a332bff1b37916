"""The port's minimal HDF5 reader/writer (calamity_tpu_torch._h5lite),
which stands in for h5py where h5py is not installed: h5py reads what it
writes value for value and type for type, it reads its own files back, and
the port's host layer's uvh5, calh5 and UVFlag writers and readers
round-trip through it (and the JAX package reads what they wrote). The
storage of the latest file format and HDF5's built-in filters (the
extensible-array chunk index with its paged data blocks, the v2 B-tree
index, szip, scale-offset, n-bit) and the types h5py and pyuvdata write
(variable-length strings, compounds of integers, integers and floats of
reduced precision) are read equal to h5py to the bit, from fixtures h5py
wrote (``tests/data_torch``) and from files written here; the digests
committed beside the fixtures for the card's machine, which has no h5py,
equal h5py's reading. What the reader still refuses raises, naming what
and where."""

import json
import os
import sys

import h5py
import numpy as np
import pytest

import calamity_tpu.io as jio
import calamity_tpu_torch.io.caldata as caldata_mod
import calamity_tpu_torch.io.flags as flags_mod
import calamity_tpu_torch.io.visdata as visdata_mod
from calamity_tpu_torch import _h5lite, simulate
from calamity_tpu_torch.io import CalData, FlagWeights, VisData

sys.path.insert(0, os.path.dirname(__file__))  # the fixture generator

VALUES = {
    "i64": np.arange(5),
    "u8": np.array([1, 2, 255], np.uint8),
    "f32": np.linspace(0, 1, 7, dtype=np.float32).reshape(7, 1),
    "c128": (np.arange(6) + 1j * np.arange(6)).reshape(2, 3),
    "c64": np.array([1 + 2j], np.complex64),
    "b": np.array([[True, False], [False, True]]),
    "s": np.bytes_("hello"),
    "s_empty": np.bytes_(""),
    "names": np.asarray([b"ANT0", b"ANT12"]),
    "int": 7,
    "float": 2.5,
    "bool": True,
    "empty": np.zeros((0, 3)),
}


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)


def test_lookup3_reference_values():
    # values from the lookup3.c self-test driver
    assert _h5lite.lookup3(b"") == 0xDEADBEEF
    assert _h5lite.lookup3(b"Four score and seven years ago") == 0x17770551
    assert _h5lite.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


@pytest.mark.parametrize("reader", ["h5py", "h5lite"])
def test_written_files_read_back(tmp_path, reader):
    path = str(tmp_path / "t.h5")
    with _h5lite.File(path, "w") as f:
        hdr = f.create_group("Header")
        for name, val in VALUES.items():
            hdr[name] = val
        f.create_group("Data").create_dataset("cube", data=np.ones((3, 1, 4, 2)))
    opener = h5py.File if reader == "h5py" else _h5lite.File
    with opener(path, "r") as f:
        assert set(f["Header"].keys()) == set(VALUES)
        for name, val in VALUES.items():
            assert _same(f["Header"][name][()], val), name
        assert "cube" in f["Data"] and f["Data"]["cube"].shape == (3, 1, 4, 2)
        out = np.empty((3, 1, 4, 2), np.float32)
        f["Data"]["cube"].read_direct(out)
        assert np.all(out == 1.0)


def test_host_layer_files_round_trip(tmp_path, monkeypatch):
    uvd = simulate.make_golomb_array(nants=4, nfreqs=16, ntimes=2, seed=1)
    gains = CalData.blank_from_visdata(uvd)
    gains.gain_array = gains.gain_array * (1 + 0.1j)
    weights = FlagWeights(uvd, mode="flag")
    paths = {k: str(tmp_path / k) for k in ("v.uvh5", "g.calh5", "w.h5")}
    for mod in (visdata_mod, caldata_mod, flags_mod):
        monkeypatch.setattr(mod, "h5py", _h5lite)
    uvd.write_uvh5(paths["v.uvh5"])
    gains.write_calh5(paths["g.calh5"])
    weights.to_uvflag_h5(paths["w.h5"])
    read_lite = (VisData.from_uvh5(paths["v.uvh5"]), CalData.from_calh5(paths["g.calh5"]),
                 FlagWeights.from_uvflag_h5(paths["w.h5"]))
    for mod in (visdata_mod, caldata_mod, flags_mod):
        monkeypatch.setattr(mod, "h5py", h5py)
    read_h5py = (VisData.from_uvh5(paths["v.uvh5"]), CalData.from_calh5(paths["g.calh5"]),
                 FlagWeights.from_uvflag_h5(paths["w.h5"]))
    # the JAX package's readers (on h5py) read what the port wrote
    read_jax = (jio.VisData.from_uvh5(paths["v.uvh5"]), jio.CalData.from_calh5(paths["g.calh5"]),
                jio.FlagWeights.from_uvflag_h5(paths["w.h5"]))
    for back in (read_lite, read_h5py, read_jax):
        v, g, w = back
        for name in ("data_array", "flag_array", "nsample_array", "time_array",
                     "ant_1_array", "freq_array", "antenna_positions"):
            assert _same(getattr(v, name), getattr(uvd, name)), name
        assert v.antenna_names == uvd.antenna_names and v.history == uvd.history
        assert _same(g.gain_array, gains.gain_array) and _same(g.flag_array, gains.flag_array)
        assert _same(w.weights_array, weights.weights_array)


DATA = os.path.join(os.path.dirname(__file__), "data")
DATA_TORCH = os.path.join(os.path.dirname(__file__), "data_torch")


def _tree(path, opener):
    """{dataset path: value as read} of every dataset of an HDF5 file, read
    with ``opener``."""
    out = {}
    with opener(path, "r") as f:
        def walk(grp, prefix):
            for name in grp.keys():
                node = grp[name]
                if hasattr(node, "keys"):
                    walk(node, f"{prefix}/{name}")
                else:
                    out[f"{prefix}/{name}"] = node[()]
        walk(f, "")
    return out


def _bit_same(got, want):
    """The same Python type, shape, dtype (with h5py's string metadata)
    and bytes (a float's sign and NaN bits; structured values member by
    member; each string of an object array)."""
    from torch_make_h5_fixture import value_bytes

    if type(got) is not type(want):
        return False
    got, want = np.asarray(got), np.asarray(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and h5py.check_string_dtype(got.dtype) == h5py.check_string_dtype(want.dtype)
            and value_bytes(got) == value_bytes(want))


def _same_tree(path):
    want, got = _tree(path, h5py.File), {}
    with h5py.File(path, "r") as f:
        dtypes = {name: f[name].dtype for name in want}
    with _h5lite.File(path, "r") as f:
        for name in want:
            got[name] = f[name][()]
            assert f[name].dtype == dtypes[name], name
        names = set()

        def walk(grp, prefix):
            for name in grp.keys():
                names.add(f"{prefix}/{name}")
                if f"{prefix}/{name}" not in want and isinstance(grp[name], _h5lite.Group):
                    walk(grp[name], f"{prefix}/{name}")
        walk(f, "")
    assert want, path
    for name, val in want.items():
        assert _bit_same(got[name], val), name
    return names


@pytest.mark.parametrize("name", ["golden_golomb_projected.uvh5", "golden_gains.calh5",
                                  "golden_weights.uvflag.h5"])
def test_repo_fixtures_read_equal_to_h5py(name):
    # h5py's default format: superblock 0, version-1 headers, symbol tables
    with open(os.path.join(DATA, name), "rb") as fh:
        assert fh.read(9)[8] == 0
    _same_tree(os.path.join(DATA, name))


def test_pyuvdata_layout_fixture_reads_equal_to_h5py_and_the_generator(tmp_path, monkeypatch):
    import torch_make_h5_fixture as gen

    path = os.path.join(DATA_TORCH, gen.FIXTURE)
    names = _same_tree(path)
    assert "/Header/extra_keywords" in names
    with h5py.File(path, "r") as f:
        assert f["Data/flags"].compression == "lzf" and f["Data/visdata"].chunks
        assert f["Header/extra_keywords/comment"].dtype.kind == "O"
    with _h5lite.File(path, "r") as f:  # a variable-length string: bytes, as h5py gives
        comment = f["Header/extra_keywords/comment"]
        assert comment.dtype.kind == "O" and h5py.check_string_dtype(comment.dtype).encoding \
            == "utf-8"
        assert comment[()] == b"a variable-length string, as pyuvdata writes one"
    fresh = gen.write_fixture(str(tmp_path / "fresh.uvh5"))
    committed, regenerated = _tree(path, h5py.File), _tree(fresh, h5py.File)
    assert committed.keys() == regenerated.keys()
    for name, val in committed.items():
        assert _same(regenerated[name], val), name
    # the port's host layer reads it through _h5lite as the JAX package
    # reads it through h5py
    monkeypatch.setattr(visdata_mod, "h5py", _h5lite)
    port = VisData.from_uvh5(path)
    ref = jio.VisData.from_uvh5(path)
    for attr in ("data_array", "flag_array", "nsample_array", "time_array", "freq_array",
                 "ant_1_array", "antenna_positions", "channel_width", "integration_time"):
        assert _same(getattr(port, attr), getattr(ref, attr)), attr
    assert port.antenna_names == ref.antenna_names and port.history == ref.history
    assert port.flag_array[:, :, 10].all() and not port.flag_array[:, :, 11].any()


def test_lzf_cube_reads_equal_to_the_generator():
    import torch_make_h5_fixture as gen

    flags, nsamples = gen.lzf_cube_arrays()
    with _h5lite.File(os.path.join(DATA_TORCH, gen.LZF_CUBE), "r") as f:
        assert _same(f["Data/flags"][()], flags)
        out = np.empty(nsamples.shape, np.float64)  # cast while reading
        f["Data/nsamples"].read_direct(out)
        assert np.array_equal(out, nsamples)


def test_szip_cube_reads_equal_to_the_generator_and_h5py():
    import torch_make_h5_fixture as gen

    flags, nsamples = gen.lzf_cube_arrays()
    path = os.path.join(DATA_TORCH, gen.SZIP_CUBE)
    with _h5lite.File(path, "r") as f, h5py.File(path, "r") as ref:
        assert ref["Data/flags"].compression == "szip"
        assert ref["Data/flags"].compression_opts == ("nn", 32)
        for name, want in (("flags", flags), ("nsamples", nsamples)):
            got = f["Data/" + name][()]
            assert _same(got, want) and _same(got, ref["Data/" + name][()]), name


def _write_case(path, case, libver):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 23)) + 1j * rng.standard_normal((37, 23))
    with h5py.File(path, "w", libver=libver) as f:
        if case == "many_links":  # dense link storage under "latest"
            g = f.create_group("Header")
            for i in range(40):
                g[f"item_{i:02d}"] = np.arange(i + 1, dtype=np.int32)
            big = f.create_group("big")  # a fractal heap with indirect blocks, a deeper B-tree
            for i in range(300):
                big[f"x{i}"] = float(i)
        elif case == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple((6,))
            ds = h5py.h5d.create(f.id, b"v", h5py.h5t.py_create(np.dtype("<f8")), space,
                                 dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6.0))
        elif case == "contiguous":
            f["v"] = x
            f["b"] = np.array([[True, False]])
            f["s"] = np.array([b"a", b"bcd"])
            f["be"] = np.arange(4, dtype=">f8")
            f["scalar"] = 3.0
        elif case == "chunked_edges":
            f.create_dataset("v", data=x, chunks=(8, 5))  # edge chunks on both axes
        elif case == "unallocated":
            ds = f.create_dataset("v", shape=(20, 20), dtype="f4", chunks=(6, 7),
                                  fillvalue=3.5)
            ds[0:6, 0:7] = 1.0
            ds[18:, 14:] = 2.0
        elif case == "single_chunk":
            f.create_dataset("v", data=x, chunks=x.shape, compression="gzip")
            f.create_dataset("w", data=x, chunks=x.shape)
        elif case == "many_chunks":  # a paged fixed array under "latest"
            ds = f.create_dataset("v", shape=(2100,), dtype="i4", chunks=(1,))
            ds[5:1500] = np.arange(5, 1500)
            f.create_dataset("w", data=np.arange(3000.0), chunks=(2,), compression="gzip")
        elif case == "gzip":
            f.create_dataset("v", data=x, chunks=(8, 5), compression="gzip")
        elif case == "shuffle_gzip":
            f.create_dataset("v", data=x, chunks=(8, 5), compression="gzip", shuffle=True)
        elif case == "lzf":
            f.create_dataset("v", data=x, chunks=(8, 5), compression="lzf")  # incompressible
            f.create_dataset("w", data=rng.random((50, 60)) < 0.1, chunks=(16, 16),
                             compression="lzf")
        elif case == "fletcher32":
            f.create_dataset("v", data=x, chunks=(8, 5), fletcher32=True)
            f.create_dataset("w", data=x.astype(np.complex64), chunks=(8, 5), fletcher32=True,
                             shuffle=True, compression="gzip")
        elif case == "unlimited_1d":  # an extensible-array index under "latest"
            f.create_dataset("v", data=np.arange(10.0), chunks=(4,), maxshape=(None,))
            f.create_dataset("w", data=x, chunks=(3, 5), maxshape=(37, None))
        elif case == "unlimited_2d":  # a v2 B-tree index under "latest"
            f.create_dataset("v", data=x, chunks=(8, 5), maxshape=(None, None),
                             compression="gzip")
        elif case == "szip":
            f.create_dataset("v", data=np.arange(64, dtype=np.int32).reshape(8, 8) % 5,
                             chunks=(8, 8), compression="szip")
            f.create_dataset("w", data=x.real, chunks=(8, 5), compression="szip",
                             compression_opts=("ec", 8))
        elif case == "scaleoffset":
            f.create_dataset("v", data=np.arange(64, dtype=np.int32), chunks=(16,),
                             scaleoffset=0)
            f.create_dataset("w", data=x.real, chunks=(8, 5), scaleoffset=3)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("case", ["many_links", "compact", "contiguous", "chunked_edges",
                                  "unallocated", "single_chunk", "many_chunks", "gzip",
                                  "shuffle_gzip", "lzf", "fletcher32", "unlimited_1d",
                                  "unlimited_2d", "szip", "scaleoffset"])
def test_h5py_written_files_read_equal(tmp_path, case, libver):
    path = str(tmp_path / f"{case}.h5")
    _write_case(path, case, libver)
    _same_tree(path)
    with open(path, "rb") as fh:
        assert fh.read(9)[8] == (0 if libver == "earliest" else 3)


def test_read_direct_casts_chunk_by_chunk(tmp_path):
    path = str(tmp_path / "c.h5")
    _write_case(path, "shuffle_gzip", "latest")
    with h5py.File(path, "r") as f:
        want = f["v"][()].astype(np.complex64)
    out = np.empty(want.shape, np.complex64)
    with _h5lite.File(path, "r") as f:
        f["v"].read_direct(out)
    assert np.array_equal(out, want)


def test_fletcher32_mismatch_raises(tmp_path):
    path = str(tmp_path / "f.h5")
    _write_case(path, "fletcher32", "earliest")
    with h5py.File(path, "r") as f:
        offset = f["v"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)[0]
        fh.seek(offset)
        fh.write(bytes([byte ^ 0xFF]))
    with _h5lite.File(path, "r") as f, pytest.raises(ValueError, match="fletcher32"):
        f["v"][()]


def _with_filter(f, fid):
    """A dataset whose pipeline lists filter ``fid`` as optional (this
    h5py cannot apply it, so HDF5 stores the chunks unfiltered)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4,))
    dcpl.set_filter(fid, h5py.h5z.FLAG_OPTIONAL, (0, 0, 0))
    space = h5py.h5s.create_simple((8,))
    ds = h5py.h5d.create(f.id, b"v", h5py.h5t.py_create(np.dtype("<f4")), space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(8, dtype=np.float32))


_PLUGINS = {"blosc": 32001, "bitshuffle": 32008, "lz4": 32004, "zstd": 32015}


@pytest.mark.parametrize("case,match", [
    ("blosc", "filter 32001 \\(blosc\\)"),
    ("bitshuffle", "filter 32008 \\(bitshuffle\\)"),
    ("lz4", "filter 32004 \\(lz4\\)"),
    ("zstd", "filter 32015 \\(zstd\\)"),
    ("nbit", "filter 5 \\(nbit\\)"),
])
def test_unsupported_storage_raises_naming_it(tmp_path, case, match):
    """The plugin filters (h5py reads them only through hdf5plugin) raise,
    naming the filter and the dataset. n-bit, which raised until the
    reader took it, reads equal to h5py."""
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver="latest") as f:
        if case in _PLUGINS:
            _with_filter(f, _PLUGINS[case])
        else:  # n-bit, which HDF5 applies itself (h5py has no set_nbit)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((4,))
            dcpl.set_filter(5, 0, ())
            ds = h5py.h5d.create(f.id, b"v", h5py.h5t.py_create(np.dtype("<i4")),
                                 h5py.h5s.create_simple((8,)), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(8, dtype=np.int32))
    with _h5lite.File(path, "r") as f:
        assert "v" in f  # opening walks the links only
        if case == "nbit":
            assert [fid for fid, _ in f["v"]._info().filters] == [5]
            assert _bit_same(f["v"][()], np.arange(8, dtype=np.int32))
            return
        with pytest.raises(ValueError, match=f"dataset '/v'.*{match}"):
            f["v"][()]


def _refused(f, case):
    """Write into ``f`` the storage ``case`` the reader refuses; return the
    name of the node that raises."""
    if case == "vlen_sequence":  # no field the host layer reads holds one
        ds = f.create_dataset("v", shape=(2,), dtype=h5py.vlen_dtype(np.int32))
        ds[0] = np.arange(3)
    elif case == "scaleoffset_full_precision":  # HDF5 1.14.6 cannot read it back
        values = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31, 100).astype(np.int32)
        f.create_dataset("v", data=values, chunks=(50,), scaleoffset=0)
    elif case == "array_datatype":  # only as a compound member
        f.create_dataset("v", shape=(3,), dtype=np.dtype(("<i4", (2,))))
    elif case in ("huge_heap_object", "filtered_heap"):  # dense link storage
        g = f.create_group("g")
        for i in range(20):
            g[f"x{i:02d}"] = i
        if case == "huge_heap_object":
            g["y" * 70000] = 1  # a link over the heap's largest managed object
        return "g"
    return "v"


@pytest.mark.parametrize("case,match", [
    ("vlen_sequence", "variable-length sequence datatype"),
    ("scaleoffset_full_precision", "scale-offset data at full precision"),
    ("array_datatype", "array datatype"),
    ("huge_heap_object", "huge and tiny fractal heap objects"),
    ("filtered_heap", "I/O filters are not supported"),
])
def test_refused_storage_raises_naming_it(tmp_path, case, match):
    """What the reader still refuses is no fault against the JAX package
    (h5py cannot read it, or no dataset the host layer reads can hold it,
    or h5py never writes it): reading it raises ``ValueError`` naming what
    and the dataset or group."""
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver="latest") as f:
        name = _refused(f, case)
    if case == "filtered_heap":  # h5py cannot filter a group's heap: mark it filtered
        with open(path, "r+b") as fh:
            at = fh.read().index(b"FRHP")
            fh.seek(at + 7)
            fh.write((4).to_bytes(2, "little"))  # the I/O filters' encoded length
    kind = "group" if name == "g" else "dataset"
    with _h5lite.File(path, "r") as f, pytest.raises(
            ValueError, match=f"{kind} '/{name}'.*{match}"):
        f[name][()]


def _storage_fixtures():
    import torch_make_h5_fixture as gen

    return gen, os.path.join(DATA_TORCH, gen.STORAGE)


@pytest.mark.parametrize("group", ["extensible_array", "btree2", "szip", "scaleoffset"])
def test_storage_fixture_reads_equal_to_h5py(group):
    gen, path = _storage_fixtures()
    names = [n for n in gen.storage_datasets() if n.startswith(group + "/")]
    with h5py.File(path, "r") as f:
        want = {n: f[n][()] for n in names}
        filters = {n: [f[n].id.get_create_plist().get_filter(i)[:3]
                       for i in range(f[n].id.get_create_plist().get_nfilters())]
                   for n in names}
        masks = {n: [f[n].id.get_chunk_info(i).filter_mask
                     for i in range(f[n].id.get_num_chunks())] for n in names}
    with _h5lite.File(path, "r") as f:
        got = {n: f[n][()] for n in names}
        index = {n: f[n]._info().index for n in names}
    for n in names:
        assert _same(got[n], want[n]), n
        values, kw = gen.storage_datasets()[n]
        if "write" in kw:
            continue
        if values.dtype.kind == "f" and "scaleoffset" in kw:  # D-scale keeps D decimals
            assert np.max(np.abs(want[n] - values)) <= 10.0 ** -kw["scaleoffset"], n
        else:
            assert _same(want[n], values), n  # h5py's reading is the generator's data
    raw = open(path, "rb").read()
    if group == "extensible_array":
        assert set(index.values()) == {"extensible_array"}
        assert raw.count(b"EASB") >= 1  # the index's secondary blocks
    elif group == "btree2":
        assert set(index.values()) == {"btree2"}
        assert raw.count(b"BTIN") >= 1  # internal nodes: depth >= 1
        assert any(filters[n] for n in names) and not all(filters[n] for n in names)
    elif group == "szip":
        options = {fl[0][2][0] & 36 for fl in filters.values()}
        assert options == {4, 32}  # EC and NN
        assert any(any(m) for m in masks.values())  # chunks stored raw (the filter skipped)
        seen = set()
        with h5py.File(path, "r") as f:
            for n in names:
                ds = f[n]
                for i in range(ds.id.get_num_chunks()):
                    mask, chunk = ds.id.read_direct_chunk(ds.id.get_chunk_info(i).chunk_offset)
                    if not mask:
                        _h5lite._szip_decompress(chunk, filters[n][0][2], seen)
        assert seen == {"zero_block", "second_extension", "fundamental_sequence",
                        "split_sample", "no_compression"}
    else:
        cls = {fl[0][2][3] for fl in filters.values()}
        fill = {fl[0][2][7] for fl in filters.values()}
        assert cls == {0, 1} and fill == {0, 1} or fill == {1}  # integer and float


@pytest.mark.parametrize("name", ["storage_layouts.h5", "unlimited_szip.uvh5",
                                  "unlimited2_szip.uvh5", "storage_types.h5",
                                  "hera_int_visdata.uvh5", "vlen_strings.uvh5",
                                  "vlen_strings.calh5", "vlen_strings.uvflag.h5"])
def test_storage_digests_equal_h5py_and_h5lite(name):
    import torch_make_h5_fixture as gen

    with open(os.path.join(DATA_TORCH, gen.DIGESTS)) as fh:
        digests = json.load(fh)[name]
    path = os.path.join(DATA_TORCH, name)
    assert gen.file_digests(path) == digests
    assert gen.file_digests(path, _h5lite.File) == digests


def test_storage_fixtures_regenerate_equal(tmp_path):
    import torch_make_h5_fixture as gen

    fresh = [gen.write_storage(str(tmp_path / gen.STORAGE))]
    fresh += [gen.write_unlimited_uvh5(str(tmp_path / n), k)
              for k, n in enumerate(gen.UVH5_UNLIMITED)]
    fresh += [gen.write_types(str(tmp_path / gen.TYPES)),
              gen.write_int_visdata(str(tmp_path / gen.INT_VISDATA)),
              gen.write_nbit_cube(str(tmp_path / gen.NBIT_CUBE))]
    fresh += [gen.write_vlen_strings(str(tmp_path / n), s) for s, n in gen.VLEN.items()]
    for path in fresh:
        committed = _tree(os.path.join(DATA_TORCH, os.path.basename(path)), h5py.File)
        regenerated = _tree(path, h5py.File)
        assert committed.keys() == regenerated.keys()
        for name, val in committed.items():
            assert _bit_same(regenerated[name], val), name


@pytest.mark.parametrize("which", [0, 1])
def test_unlimited_szip_uvh5_read_by_the_port_as_the_jax_package_reads_it(monkeypatch, which):
    """``visdata`` under an extensible array (0) or a v2 B-tree (1), flags and
    nsamples szip- or scale-offset-filtered: the port's host layer reads the
    file through _h5lite as the JAX package reads it through h5py."""
    import torch_make_h5_fixture as gen

    path = os.path.join(DATA_TORCH, gen.UVH5_UNLIMITED[which])
    _same_tree(path)
    with _h5lite.File(path, "r") as f:
        assert f["Data/visdata"]._info().index == ("extensible_array", "btree2")[which]
        assert [fid for fid, _ in f["Data/flags"]._info().filters] == [4]
    monkeypatch.setattr(visdata_mod, "h5py", _h5lite)
    port = VisData.from_uvh5(path)
    ref = jio.VisData.from_uvh5(path)
    for attr in ("data_array", "flag_array", "nsample_array", "time_array", "freq_array",
                 "ant_1_array", "antenna_positions", "channel_width", "integration_time"):
        assert _same(getattr(port, attr), getattr(ref, attr)), attr
    assert port.flag_array[:, :, 10].all() and not port.flag_array[:, :, 11].any()


def test_jax_writers_read_by_the_port_host_layer(tmp_path, monkeypatch):
    """The JAX package's uvh5 (both layouts), calh5 and UVFlag writers,
    through h5py; the port's host layer reads them through _h5lite as the
    JAX package reads them through h5py."""
    juvd = jio.VisData.from_uvh5(os.path.join(DATA, "golden_golomb_projected.uvh5"))
    jcal = jio.CalData.from_calh5(os.path.join(DATA, "golden_gains.calh5"))
    jw = jio.FlagWeights.from_uvflag_h5(os.path.join(DATA, "golden_weights.uvflag.h5"))
    paths = {k: str(tmp_path / k) for k in ("v01.uvh5", "v10.uvh5", "g.calh5", "w.h5")}
    juvd.write_uvh5(paths["v01.uvh5"])
    juvd.write_uvh5(paths["v10.uvh5"], version="1.0")
    jcal.write_calh5(paths["g.calh5"])
    jw.to_uvflag_h5(paths["w.h5"])
    for mod in (visdata_mod, caldata_mod, flags_mod):
        monkeypatch.setattr(mod, "h5py", _h5lite)
    for key in ("v01.uvh5", "v10.uvh5"):
        got, want = VisData.from_uvh5(paths[key]), jio.VisData.from_uvh5(paths[key])
        for name in ("data_array", "flag_array", "nsample_array", "time_array", "freq_array",
                     "ant_1_array", "ant_2_array", "antenna_positions", "uvw_array",
                     "polarization_array", "lst_array", "integration_time"):
            assert _same(getattr(got, name), getattr(want, name)), (key, name)
        assert got.antenna_names == want.antenna_names and got.history == want.history
        assert got.channel_width == want.channel_width
        small = VisData.from_uvh5(paths[key], data_dtype=np.complex64)
        assert _same(small.data_array, want.data_array.astype(np.complex64))
    got, want = CalData.from_calh5(paths["g.calh5"]), jio.CalData.from_calh5(paths["g.calh5"])
    for name in ("gain_array", "flag_array", "quality_array", "ant_array", "freq_array",
                 "time_array", "jones_array"):
        assert _same(getattr(got, name), getattr(want, name)), name
    got = FlagWeights.from_uvflag_h5(paths["w.h5"])
    want = jio.FlagWeights.from_uvflag_h5(paths["w.h5"])
    assert _same(got.weights_array, want.weights_array)


def test_unsupported_use_raises(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        _h5lite.File(str(tmp_path / "x.h5"), "a")
    with pytest.raises(TypeError, match="not supported"):
        with _h5lite.File(str(tmp_path / "y.h5"), "w") as f:
            f["u"] = np.array(["unicode"])


# ---------------------------------------------------------------------- #
# the types and storage of files the JAX package reads through h5py
# (tests/data_torch/storage_types.h5 and the host-layer files beside it)
# ---------------------------------------------------------------------- #
def _types_fixture():
    import torch_make_h5_fixture as gen

    return gen, os.path.join(DATA_TORCH, gen.TYPES)


@pytest.mark.parametrize("group", ["vlen_strings", "compound", "nbit", "ea_paged"])
def test_types_fixture_reads_equal_to_h5py(group):
    """Every dataset of a group reads equal to h5py to the bit (its type,
    dtype with h5py's string metadata, shape and bytes), h5py's reading is
    the generator's values where the stored type holds them exactly, and
    the file holds the storage the group is named for."""
    gen, path = _types_fixture()
    values = {n: v for n, (v, _) in gen.types_datasets().items() if n.startswith(group + "/")}
    with h5py.File(path, "r") as f:
        want = {n: f[n][()] for n in values}
        dtypes = {n: f[n].dtype for n in values}
        plists = {n: f[n].id.get_create_plist() for n in values}
        filters = {n: [p.get_filter(i)[0] for i in range(p.get_nfilters())]
                   for n, p in plists.items()}
        layouts = {n: p.get_layout() for n, p in plists.items()}
    with _h5lite.File(path, "r") as f:
        got = {n: f[n][()] for n in values}
        infos = {n: f[n]._info() for n in values}
    for n in values:
        assert _bit_same(got[n], want[n]), n
        assert infos[n].dtype == dtypes[n], n
    if group == "vlen_strings":
        assert all(infos[n].type.vlen for n in values)
        assert {h5py.check_string_dtype(d).encoding for d in dtypes.values()} == {"utf-8",
                                                                                   "ascii"}
        assert {layouts[n] for n in values} == {h5py.h5d.COMPACT, h5py.h5d.CONTIGUOUS,
                                                h5py.h5d.CHUNKED}
        assert filters["vlen_strings/chunked_gzip"] == [1]
        assert isinstance(got["vlen_strings/scalar_utf8"], bytes)  # a scalar: bytes
        assert list(got["vlen_strings/never_written"]) == [b"", b"one", b"", b""]
        for n, v in values.items():
            assert list(np.asarray(got[n], object).reshape(-1)) == [
                s if isinstance(s, bytes) else s.encode() for s in v.reshape(-1)], n
    elif group == "compound":
        for n, v in values.items():
            assert got[n].dtype.names and _same(got[n], v), n  # integers: exact
        assert np.abs(got["compound/int32_ri"]["r"]).max() > 2 ** 24
        assert got["compound/int32_ri_big_endian"].dtype["r"] == np.dtype(">i4")
        assert got["compound/padded"].dtype.itemsize == 24
    elif group == "nbit":
        assert all(filters[n][0] == 5 for n in values)
        assert filters["nbit/u8_precision3_deflate"] == [5, 1]
        cds = {n: info.filters[0][1] for n, info in infos.items()}
        assert cds["nbit/i32_full_precision"][1] == 1  # need-not-compress
        assert all(cd[1] == 0 for n, cd in cds.items() if n != "nbit/i32_full_precision")
        assert cds["nbit/compound"][3] == 3  # a compound class tree, with an array member
        assert 2 in cds["nbit/compound"][4:]
        assert infos["nbit/i16_precision10_offset3_big_endian"].dtype == np.dtype(">i2")
        assert dtypes["nbit/f64_as_float32_big_endian"] == np.dtype(">f8")
        for n, v in values.items():
            if v.dtype.kind in "iu":
                assert _same(got[n], v), n  # the values fit their precision
        cmp = values["nbit/compound"]
        for m in ("a", "c"):
            assert _same(got["nbit/compound"][m], cmp[m]), m
        f24 = got["nbit/f32_mantissa15"]  # 15 mantissa bits, rounded on writing
        v = values["nbit/f32_mantissa15"]
        normal = np.isfinite(v) & (np.abs(v) > 1e-37)
        assert f24.dtype == np.float32
        assert np.max(np.abs(f24[normal] - v[normal]) / np.abs(v[normal])) <= 2.0 ** -15
        assert _same(np.signbit(f24[~normal]), np.signbit(v[~normal]))
        assert _same(np.isinf(f24), np.isinf(v)) and _same(np.isnan(f24), np.isnan(v))
        # subnormals kept, but 2e-45, under the float24's least
        assert f24[~normal & np.isfinite(v)].astype(bool).sum() == 2
        assert _same(got["nbit/f64_as_float32_big_endian"],
                     values["nbit/f64_as_float32_big_endian"].astype(np.float32).astype(">f8"))
    else:
        for n, v in values.items():
            assert _same(got[n], v), n  # every element never written: the fill value
            assert infos[n].index == "extensible_array" and infos[n].shape[0] > 131060, n
        with open(path, "rb") as fh:
            assert fh.read().count(b"EASB") >= 2  # the data blocks past 131,060 chunks are paged


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("name", ["int32_ri", "int32_ri_big_endian", "int16_ri_chunked",
                                  "int32_ir"])
def test_compound_read_direct_into_complex(name, dtype):
    """``read_direct`` of pyuvdata's integer visibilities into complex
    converts member by member by name as HDF5 does: int32 to float32
    rounds as HDF5 rounds, above 2**24 too."""
    _, path = _types_fixture()
    with h5py.File(path, "r") as f:
        want = np.empty(f["compound/" + name].shape, dtype)
        f["compound/" + name].read_direct(want)
    got = np.empty(want.shape, dtype)
    with _h5lite.File(path, "r") as f:
        f["compound/" + name].read_direct(got)
    assert _bit_same(got, want)


def _port_reads_with_h5lite(monkeypatch):
    for mod in (visdata_mod, caldata_mod, flags_mod):
        monkeypatch.setattr(mod, "h5py", _h5lite)


def test_vlen_string_files_read_by_the_port_as_the_jax_package_reads_them(monkeypatch):
    """The repo's uvh5, calh5 and UVFlag fixtures with their Header strings
    as variable-length strings: the port's readers, through _h5lite, hold
    what the JAX package's hold through h5py."""
    import torch_make_h5_fixture as gen

    paths = {src: os.path.join(DATA_TORCH, name) for src, name in gen.VLEN.items()}
    for path in paths.values():
        _same_tree(path)
        with h5py.File(path, "r") as f:
            assert f["Header/history"].dtype.kind == "O"
    _port_reads_with_h5lite(monkeypatch)
    v_path, g_path, w_path = paths.values()
    got, want = VisData.from_uvh5(v_path), jio.VisData.from_uvh5(v_path)
    for name in ("data_array", "flag_array", "nsample_array", "time_array", "freq_array",
                 "ant_1_array", "antenna_positions"):
        assert _same(getattr(got, name), getattr(want, name)), name
    for name in visdata_mod._STR_FIELDS + ("antenna_names",):
        assert getattr(got, name) == getattr(want, name), name
    assert got.telescope_name == "SYNTH" and got.antenna_names[:2] == ["ANT0", "ANT1"]
    got, want = CalData.from_calh5(g_path), jio.CalData.from_calh5(g_path)
    assert _same(got.gain_array, want.gain_array) and _same(got.flag_array, want.flag_array)
    for name in caldata_mod._STRINGS + ("antenna_names",):
        assert getattr(got, name) == getattr(want, name), name
    got, want = FlagWeights.from_uvflag_h5(w_path), jio.FlagWeights.from_uvflag_h5(w_path)
    assert _same(got.weights_array, want.weights_array)
    for name in ("mode", "x_orientation", "history", "label"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_int_visdata_file_read_by_the_port_as_the_jax_package_reads_it(monkeypatch, dtype):
    """pyuvdata's integer visibilities (HERA's correlator files): the port's
    ``VisData.from_uvh5(..., data_dtype)`` through _h5lite holds what the
    JAX package's holds through h5py."""
    import torch_make_h5_fixture as gen

    path = os.path.join(DATA_TORCH, gen.INT_VISDATA)
    _same_tree(path)
    with h5py.File(path, "r") as f:
        assert f["Data/visdata"].dtype == np.dtype([("r", "<i4"), ("i", "<i4")])
        assert f["Data/flags"].compression == "lzf" and f["Data/visdata"].chunks
    _port_reads_with_h5lite(monkeypatch)
    got = VisData.from_uvh5(path, data_dtype=dtype)
    want = jio.VisData.from_uvh5(path, data_dtype=dtype)
    for name in ("data_array", "flag_array", "nsample_array", "time_array", "freq_array",
                 "ant_1_array", "antenna_positions"):
        assert _same(getattr(got, name), getattr(want, name)), name
    assert got.antenna_names == want.antenna_names and got.history == want.history
    ref = gen.make_visdata().data_array * gen.INT_SCALE  # the rounding, and nothing else
    assert np.max(np.abs(got.data_array - ref)) <= 0.71


def test_int_visdata_file_driver_matches_jax(tmp_path, monkeypatch):
    """The file driver with ``host_data_dtype="complex64"`` on the integer
    visibilities, the port through _h5lite on the CPU against the JAX
    driver through h5py, within the file driver's tolerance
    (``tests/test_torch_calibration.py``: gains 1e-3 of their amplitude,
    the model 1e-3 of its peak)."""
    import torch_make_h5_fixture as gen

    from calamity_tpu import calibration as jcal
    from calamity_tpu_torch import calibration as tcal

    path = os.path.join(DATA_TORCH, gen.INT_VISDATA)
    kw = dict(input_data_files=path, maxsteps=100, tol=1e-10, min_dly=gen.MIN_DLY_NS,
              offset=gen.MIN_DLY_NS, host_data_dtype="complex64")
    mj, rj, gj, _ = jcal.read_calibrate_and_model_dpss(**kw)
    _port_reads_with_h5lite(monkeypatch)
    out = str(tmp_path / "model.uvh5")
    mt, rt, gt, _ = tcal.read_calibrate_and_model_dpss(device="cpu", model_outfilename=out,
                                                       **kw)
    assert mt.data_array.dtype == mj.data_array.dtype == np.complex64
    scale = np.max(np.abs(mj.data_array))
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * scale
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3 * np.max(np.abs(gj.gain_array))
    good = ~rt.flag_array
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    assert rms(rt.data_array[good]) <= 1e-2 * rms(mt.data_array[good])
    assert VisData.from_uvh5(out).data_array.dtype == np.complex128


def test_nbit_cube_reads_equal_to_the_generator_and_h5py():
    """The HERA core's flags and nsamples cubes under n-bit then deflate
    read as their LZF twin (flags one bit, as uint8; nsamples a 16-bit
    float, as float32) and equal to h5py."""
    import torch_make_h5_fixture as gen

    flags, nsamples = gen.lzf_cube_arrays()
    path = os.path.join(DATA_TORCH, gen.NBIT_CUBE)
    with _h5lite.File(path, "r") as f, h5py.File(path, "r") as ref:
        for name, want in (("flags", flags.astype(np.uint8)), ("nsamples", nsamples)):
            got = f["Data/" + name][()]
            assert [fid for fid, _ in f["Data/" + name]._info().filters] == [5, 1], name
            assert _bit_same(got, want) and _bit_same(got, ref["Data/" + name][()]), name
    assert os.path.getsize(path) < 1 << 20

