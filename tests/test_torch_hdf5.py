"""The port's minimal HDF5 reader/writer (calamity_tpu_torch._h5lite),
which stands in for h5py where h5py is not installed: h5py reads what it
writes value for value and type for type, it reads its own files back, and
the port's host layer's uvh5, calh5 and UVFlag writers and readers
round-trip through it (and the JAX package reads what they wrote)."""

import h5py
import numpy as np
import pytest

import calamity_tpu.io as jio
import calamity_tpu_torch.io.caldata as caldata_mod
import calamity_tpu_torch.io.flags as flags_mod
import calamity_tpu_torch.io.visdata as visdata_mod
from calamity_tpu_torch import _h5lite, simulate
from calamity_tpu_torch.io import CalData, FlagWeights, VisData

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


def test_unsupported_use_raises(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        _h5lite.File(str(tmp_path / "x.h5"), "a")
    with pytest.raises(TypeError, match="not supported"):
        with _h5lite.File(str(tmp_path / "y.h5"), "w") as f:
            f["u"] = np.array(["unicode"])
