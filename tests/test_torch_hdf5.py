"""The port's minimal HDF5 reader/writer (calamity_tpu_torch._h5lite),
which stands in for h5py where h5py is not installed: h5py reads what it
writes value for value and type for type, it reads its own files back, and
the port's host layer's uvh5, calh5 and UVFlag writers and readers
round-trip through it (and the JAX package reads what they wrote). The
storage of the latest file format and HDF5's built-in filters (the
extensible-array and v2 B-tree chunk indices, szip, scale-offset) is read
equal to h5py to the bit, from fixtures h5py wrote (``tests/data_torch``)
and from files written here; the digests committed beside the fixtures
for the card's machine, which has no h5py, equal h5py's reading."""

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
    """{dataset path: value} of every dataset of an HDF5 file, read with
    ``opener``; variable-length datasets (which the port never reads) are
    left out by name."""
    out = {}
    with opener(path, "r") as f:
        def walk(grp, prefix):
            for name in grp.keys():
                node = grp[name]
                if hasattr(node, "keys"):
                    walk(node, f"{prefix}/{name}")
                elif not (hasattr(node, "dtype") and node.dtype.kind == "O"):
                    out[f"{prefix}/{name}"] = np.asarray(node[()])
        walk(f, "")
    return out


def _same_tree(path):
    want, got = _tree(path, h5py.File), {}
    with _h5lite.File(path, "r") as f:
        for name in want:
            got[name] = np.asarray(f[name][()])
        names = set()

        def walk(grp, prefix):
            for name in grp.keys():
                names.add(f"{prefix}/{name}")
                if f"{prefix}/{name}" not in want and isinstance(grp[name], _h5lite.Group):
                    walk(grp[name], f"{prefix}/{name}")
        walk(f, "")
    assert want, path
    for name, val in want.items():
        assert _same(got[name], val), name
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
    with _h5lite.File(path, "r") as f:
        with pytest.raises(ValueError, match="variable-length"):
            f["Header/extra_keywords/comment"][()]
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
        with pytest.raises(ValueError, match=f"dataset '/v'.*{match}"):
            f["v"][()]


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
                                  "unlimited2_szip.uvh5"])
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
    for path in fresh:
        committed = _tree(os.path.join(DATA_TORCH, os.path.basename(path)), h5py.File)
        regenerated = _tree(path, h5py.File)
        assert committed.keys() == regenerated.keys()
        for name, val in committed.items():
            assert _same(regenerated[name], val), name


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
