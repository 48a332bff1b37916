"""The port's ('data', 'bl') device mesh (calamity_tpu_torch.parallel.mesh)
on the CPU, in worlds of 2 and 4 gloo processes (tests/torch_mesh_worlds.py,
each under its own time limit).

- The padding helpers equal the JAX package's bit for bit on dense, shared
  and shared-batched chunks (numpy, no world).
- make_mesh's shapes and errors (tests/test_parallel.py:23-30).
- The sharded time-parallel path against the JAX package on the same mesh
  shape over its virtual CPU devices, with the criteria of
  tests/test_torch_time_parallel.py:62-73 (equal history lengths, gains
  within 1e-3, model and resid within 1e-3 x data rms): meshes (1, 2),
  (2, 1) (the mixed schedule, 3 -> 4 batch padding) and (2, 2) (3 -> 4
  batch and 15 -> 16 group padding).
- In float64 each sharded run equals the port's unsharded run: the same
  step counts and histories within rel 1e-9, with the "sum" prior, LAMB
  (on a batch the mesh does not pad: LAMB's whole-leaf norms count the
  dummy rows, as the JAX package's do), patience with use_min, a blocked
  loss, model-SNR weights and shared-batched chunks; the zero-plateau
  patience fit through ``batched_fit_core`` and ``shard_chunk``
  (tests/test_parallel.py:970).
- A cut and resumed checkpointed mesh run equals the uninterrupted one bit
  for bit; the CLI in a 2-rank world writes each file once, equal to the
  one-process CLI's, and on the serial path (no mesh) rank 0 alone writes
  the checkpoints.
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_time_parallel import _assert_agree
from torch_mesh_worlds import (
    cli_counting_saves,
    cli_main,
    cut_and_resume,
    mesh_checks,
    run_world,
    time_parallel_cases,
    zero_plateau,
)
from torch_parity import DPSS_DLY, as_port, gain_corrupted, multitime_visdata

from calamity_tpu import calibration as jcal
from calamity_tpu import parallel as jparallel
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch import cli as tcli
from calamity_tpu_torch import io as tio
from calamity_tpu_torch.parallel import mesh as tmesh
from calamity_tpu_torch.parallel.batched import batched_fit_core
from calamity_tpu_torch.solver.fit import FitConfig

COMMON = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, tol=1e-10, learning_rate=1e-2,
              model_regularization="post_hoc", shared_basis=False, correct_resid=True)
F64 = dict(COMMON, dtype=np.float64, maxsteps=80)


@pytest.fixture(scope="module")
def corrupted_multitime(golomb_visdata):
    """Three times of the 6-antenna Golomb array (15 groups), 5% gain errors."""
    return gain_corrupted(multitime_visdata(golomb_visdata))


@pytest.fixture(scope="module")
def shared_batched():
    """The grid-core array of tests/test_parallel.py, whose shared-basis
    packing has shared-batched chunks, with its DPSS components and 5% gain
    errors (a fit with real gradients: at the exact projection's noise
    floor the descent's direction is rounding, in any reduction order)."""
    from test_parallel import _grid_core_multitime

    uvd, comps = _grid_core_multitime(ntimes=2)
    return gain_corrupted(uvd), comps


def _jax_mesh(n_data, n_bl):
    return jparallel.make_mesh(n_data=n_data, n_bl=n_bl, devices=jax.devices()[:n_data * n_bl])


def _unsharded(uvd, **kw):
    return tcal.calibrate_and_model_dpss(uvdata=as_port(uvd), device="cpu", time_parallel=True,
                                         **kw)


def _assert_equal_f64(got, want):
    """A sharded float64 run against the unsharded one: equal step counts,
    histories within rel 1e-9, outputs to rounding."""
    hist = want[3]
    for pol, by_t in hist.items():
        assert sorted(got["hist"][pol]) == sorted(by_t)
        for t, h in by_t.items():
            a, b = np.asarray(got["hist"][pol][t]["loss"]), np.asarray(h["loss"])
            assert len(a) == len(b)
            assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-9
            assert got["hist"][pol][t].get("phase_steps") == h.get("phase_steps")
    scale = np.max(np.abs(want[0].data_array))
    assert np.max(np.abs(got["model"] - want[0].data_array)) <= 1e-9 * scale
    assert np.max(np.abs(got["resid"] - want[1].data_array)) <= 1e-9 * scale
    assert np.max(np.abs(got["gains"] - want[2].gain_array)) <= 1e-9
    np.testing.assert_array_equal(got["gain_flags"], want[2].flag_array)


def _same_on_every_rank(results):
    for other in results[1:]:
        for name, out in results[0].items():
            for key in ("model", "resid", "gains"):
                np.testing.assert_array_equal(other[name][key], out[key])
            for pol, by_t in out["hist"].items():
                for t, h in by_t.items():
                    assert other[name]["hist"][pol][t]["loss"] == h["loss"]


def _as_outputs(d):
    return (type("M", (), {"data_array": d["model"], "flag_array": d["model_flags"]})(),
            type("R", (), {"data_array": d["resid"], "flag_array": d["resid_flags"]})(),
            type("G", (), {"gain_array": d["gains"], "flag_array": d["gain_flags"]})(),
            d["hist"])


# ---------------------------------------------------------------------- #
# no world
# ---------------------------------------------------------------------- #
def _layouts(rng):
    f, v = 8, 3
    dense = (rng.standard_normal((5, 2, f, v)).astype(np.float32),
             rng.integers(0, 4, (5, 2)).astype(np.int32), rng.integers(0, 4, (5, 2)).astype(
                 np.int32))
    shared = (rng.standard_normal((1, 1, f, v)).astype(np.float32),
              rng.integers(0, 4, (7, 1)).astype(np.int32), rng.integers(0, 4, (7, 1)).astype(
                  np.int32))
    # shared-batched: 3 operator classes of gmax 4 groups (class-major)
    sbatched = (rng.standard_normal((3, 1, f, v)).astype(np.float32),
                rng.integers(0, 4, (12, 1)).astype(np.int32),
                rng.integers(0, 4, (12, 1)).astype(np.int32))
    return [dense, shared, sbatched]


@pytest.mark.parametrize("n_bl", [1, 2, 3, 4])
def test_padding_helpers_bit_equal_to_jax(n_bl):
    chunks = _layouts(np.random.default_rng(n_bl))
    want, want_pads = jcal._pad_chunks_for_bl(chunks, n_bl)
    for form in (lambda x: x, torch.as_tensor):
        got, pads = tcal._pad_chunks_for_bl([tuple(form(x) for x in c) for c in chunks], n_bl)
        assert pads == want_pads
        for gc, wc in zip(got, want):
            for g, w in zip(gc, wc):
                g = g.numpy() if isinstance(g, torch.Tensor) else g
                assert g.dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, np.asarray(w))
    # shared-batched: whole classes per rank, dummy groups at the end
    assert want_pads[2] == -(-3 // n_bl) * n_bl * 4
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(tcal._pad_axis_np(x, 0, 5), np.asarray(jcal._pad_axis_np(x, 0,
                                                                                           5)))
    np.testing.assert_array_equal(tcal._pad_axis(torch.as_tensor(x), 1, 4).numpy(),
                                  np.asarray(jcal._pad_axis(x, 1, 4)))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
    with pytest.raises(TypeError, match="DeviceMesh from make_mesh"):
        tmesh.fit_shardings(object())


# ---------------------------------------------------------------------- #
# worlds
# ---------------------------------------------------------------------- #
def test_mesh_1x2_against_jax_and_unsharded(corrupted_multitime, shared_batched, tmp_path):
    """(1, 2): float32 against the JAX package on the same mesh; float64
    against the unsharded port, with the "sum" prior, LAMB, a blocked loss,
    model-SNR weights and shared-batched chunks."""
    sb_uvd, sb_comps = shared_batched
    sb_kw = dict(F64, shared_basis=True, fg_model_comps_dict=sb_comps, maxsteps=60)
    f32 = dict(COMMON, maxsteps=150, comps_precision="float32")
    cases = [("f32", as_port(corrupted_multitime), f32),
             ("sum", as_port(corrupted_multitime), dict(F64, model_regularization="sum")),
             ("lamb", as_port(corrupted_multitime), dict(F64, optimizer="LAMB", maxsteps=40)),
             ("block", as_port(corrupted_multitime), dict(F64, loss_block_ngrps=4)),
             ("snr", as_port(corrupted_multitime), dict(F64, use_model_snr_weights=True)),
             ("shared_batched", as_port(sb_uvd), sb_kw)]
    results = run_world(time_parallel_cases, 2, tmp_path, (1, 2), cases)
    _same_on_every_rank(results)
    got = results[0]
    jout = jcal.calibrate_and_model_dpss(uvdata=corrupted_multitime, time_parallel=True,
                                         mesh=_jax_mesh(1, 2), **f32)
    _assert_agree(jout, _as_outputs(got["f32"]), corrupted_multitime)
    # one all-reduce of the losses and the gain gradients per step
    assert got["f32"]["timings"]["collective_calls"] >= got["f32"]["timings"]["phase_steps"][0]
    for name, uvd, kw in cases[1:]:
        src = sb_uvd if name == "shared_batched" else corrupted_multitime
        _assert_equal_f64(got[name], _unsharded(src, **kw))


def test_mesh_2x1_mixed_schedule_against_jax(corrupted_multitime, tmp_path):
    """(2, 1): three slices padded to four rows; the mixed schedule against
    the JAX package on the same mesh, and float64 against the unsharded
    port."""
    mixed = dict(COMMON, maxsteps=150, comps_precision="mixed")
    cases = [("mixed", as_port(corrupted_multitime), mixed),
             ("f64", as_port(corrupted_multitime), F64)]
    results = run_world(time_parallel_cases, 2, tmp_path, (2, 1), cases)
    _same_on_every_rank(results)
    jout = jcal.calibrate_and_model_dpss(uvdata=corrupted_multitime, time_parallel=True,
                                         mesh=_jax_mesh(2, 1), **mixed)
    _assert_agree(jout, _as_outputs(results[0]["mixed"]), corrupted_multitime)
    assert all(len(h["phase_steps"]) == 2 for h in results[0]["mixed"]["hist"][0].values())
    _assert_equal_f64(results[0]["f64"], _unsharded(corrupted_multitime, **F64))


def test_mesh_2x2_padding_patience_and_shapes(corrupted_multitime, tmp_path):
    """(2, 2): 3 -> 4 batch and 15 -> 16 group padding against the JAX
    package on the same mesh; patience with use_min in float64 against the
    unsharded port; make_mesh's shapes and errors on a world of 4."""
    f32 = dict(COMMON, maxsteps=150, comps_precision="float32")
    patience = dict(F64, tol=0.0, patience=15, use_min=True)
    cases = [("f32", as_port(corrupted_multitime), f32),
             ("patience", as_port(corrupted_multitime), patience)]
    results = run_world(time_parallel_cases, 4, tmp_path, (2, 2), cases)
    _same_on_every_rank(results)
    jout = jcal.calibrate_and_model_dpss(uvdata=corrupted_multitime, time_parallel=True,
                                         mesh=_jax_mesh(2, 2), **f32)
    _assert_agree(jout, _as_outputs(results[0]["f32"]), corrupted_multitime)
    _assert_equal_f64(results[0]["patience"], _unsharded(corrupted_multitime, **patience))

    shapes = run_world(mesh_checks, 4, tmp_path)[0]
    assert shapes["default"] == {"data": 1, "bl": 4}
    assert shapes["data2"] == shapes["bl2"] == {"data": 2, "bl": 2}
    assert shapes["names"] == ("data", "bl")
    assert shapes["error"] == "mesh 3x5 != 4 devices"


def test_patience_freeze_composes_with_mesh(tmp_path):
    """The per-slice patience carry shards like the freeze mask: the
    zero-plateau fit sharded over (2, 2) freezes at the same step as the
    one-process fit, with the same histories (tests/test_parallel.py:970)."""
    from conftest import zero_plateau_fit_args

    chunks, data_r, data_i, wgts, g_r, g_i, fg = zero_plateau_fit_args()
    comps, a0, a1 = (np.asarray(x) for x in chunks[0])
    # the group axis padded to 2 for 'bl' by the caller: 6 groups divide
    stack = lambda x: np.stack([np.asarray(x), np.asarray(x)])  # noqa: E731
    arrays = (comps, a0, a1, stack(data_r[0]), stack(data_i[0]), stack(wgts[0]), stack(g_r),
              stack(g_i), stack(fg[0]))
    cfg = FitConfig(optimizer="Adamax", opt_kwargs=(("learning_rate", 1e-2),), maxsteps=200,
                    tol=0.0, use_min=True, patience=40)
    got = run_world(zero_plateau, 4, tmp_path, (2, 2), arrays, cfg)[0]
    t = [torch.as_tensor(x) for x in arrays]
    want = batched_fit_core(cfg, ((t[0], t[1], t[2]),), (t[3],), (t[4],), (t[5],), t[6], t[7],
                            (t[8],), (torch.zeros_like(t[8]),), torch.zeros(2), torch.zeros(2))
    assert got["nsteps_slice"] == want.nsteps_slice.tolist() == [41, 41]
    assert np.array_equal(got["history"], want.loss_history, equal_nan=True)
    np.testing.assert_array_equal(got["final"], want.final_loss.numpy())


@pytest.mark.parametrize("scan", [False, True], ids=["time_parallel", "scan"])
def test_cut_and_resumed_mesh_run_equals_uninterrupted(corrupted_multitime, tmp_path, scan):
    """A checkpointed run on (1, 2) stopped on every rank after a save,
    resumed into the same directory, equals an uninterrupted run bit for
    bit (histories, model, resid, gains); the time-parallel path under the
    mixed schedule, the scan with its mid-time checkpoints and markers."""
    kw = dict(COMMON, maxsteps=60, tol=0.0, comps_precision="mixed", checkpoint_every=25)
    if scan:
        kw["init_guesses_from_previous_time_step"] = True
    # the scan: in time 1's bf16 phase (time 0's marker restored); the
    # time-parallel path: in the float32 polish (the bf16 phase's
    # diagnostics restored)
    cut_at = 8 if scan else 5
    results = run_world(cut_and_resume, 2, tmp_path, (1, 2), as_port(corrupted_multitime), kw,
                        str(tmp_path / "ck"), cut_at)
    resumed, straight, saves = results[0]
    assert saves == cut_at  # the cut run was stopped there

    def steps(hist):  # the fit's record, without its host seconds
        return {t: (h["loss"], h["phase_steps"]) for t, h in hist[0].items()}

    assert steps(resumed["hist"]) == steps(straight["hist"])
    for key in ("model", "resid", "gains"):
        np.testing.assert_array_equal(resumed[key], straight[key])
    assert steps(results[1][0]["hist"]) == steps(straight["hist"])


def test_cli_in_a_two_rank_world_writes_once(corrupted_multitime, tmp_path):
    """The port's CLI with --time_parallel in a world of 2 that torchrun
    would start (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT; gloo for
    --device cpu): rank 0 alone writes, and the files equal the
    one-process CLI's to the float32 sums' order."""
    path = str(tmp_path / "in.uvh5")
    corrupted_multitime.write_uvh5(path)

    def argv(tag):
        return ["--input_data_files", path, "--resid_outfilename", str(tmp_path / f"{tag}_r.uvh5"),
                "--model_outfilename", str(tmp_path / f"{tag}_m.uvh5"), "--gain_outfilename",
                str(tmp_path / f"{tag}_g.calfits"), "--fitted_info_outfilename",
                str(tmp_path / f"{tag}_info.npy"), "--min_dly", str(DPSS_DLY), "--offset",
                str(DPSS_DLY), "--maxsteps", "100", "--tol", "1e-10", "--time_parallel",
                "--precision", "64", "--device", "cpu"]

    before = set(os.listdir(tmp_path))
    assert run_world(cli_main, 2, tmp_path, argv("w"), torchrun_env=True) == [True, True]
    written = sorted(set(os.listdir(tmp_path)) - before)
    assert written == sorted(["w_r.uvh5", "w_m.uvh5", "w_g.calfits", "w_info.npy"])
    tcli.main(argv("one"))
    for key in ("r.uvh5", "m.uvh5"):
        a = tio.VisData.from_uvh5(str(tmp_path / f"w_{key}"))
        b = tio.VisData.from_uvh5(str(tmp_path / f"one_{key}"))
        np.testing.assert_array_equal(a.flag_array, b.flag_array)
        assert np.max(np.abs(a.data_array - b.data_array)) <= 1e-9 * np.max(np.abs(b.data_array))
    ga = tio.CalData.from_calfits(str(tmp_path / "w_g.calfits"))
    gb = tio.CalData.from_calfits(str(tmp_path / "one_g.calfits"))
    assert np.max(np.abs(ga.gain_array - gb.gain_array)) <= 1e-9
    ia = np.load(str(tmp_path / "w_info.npy"), allow_pickle=True).item()
    ib = np.load(str(tmp_path / "one_info.npy"), allow_pickle=True).item()
    assert [len(h["loss"]) for h in ia[0].values()] == [len(h["loss"]) for h in ib[0].values()]


def test_serial_cli_in_a_two_rank_world_checkpoints_once(corrupted_multitime, tmp_path):
    """The port's CLI without --time_parallel and with --checkpoint_dir in a
    world of 2 that torchrun would start: the serial path ignores the mesh,
    so each rank fits the whole file on its own, and rank 0 alone writes
    the checkpoints (no two processes write one directory) and the
    outputs; both equal the one-process CLI's, and a rerun into the same
    directory resumes on rank 0 to the same files."""
    path = str(tmp_path / "in.uvh5")
    corrupted_multitime.write_uvh5(path)

    def argv(tag, out=None):
        return ["--input_data_files", path, "--resid_outfilename",
                str(tmp_path / f"{out or tag}_r.uvh5"), "--checkpoint_dir",
                str(tmp_path / f"{tag}_ck"), "--checkpoint_every", "25", "--min_dly",
                str(DPSS_DLY), "--offset", str(DPSS_DLY), "--maxsteps", "60", "--tol", "0",
                "--precision", "64", "--device", "cpu", "--clobber"]

    def tree(tag):
        root = tmp_path / f"{tag}_ck"
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    saves = run_world(cli_counting_saves, 2, tmp_path, argv("w"), torchrun_env=True)
    assert saves[0] and not saves[1]
    assert len(saves[0]) == len(set(saves[0]))
    tcli.main(argv("one"))
    assert tree("w") == tree("one")
    resumed = run_world(cli_counting_saves, 2, tmp_path, argv("w", "again"), torchrun_env=True)
    assert resumed == [[], []]  # every fit resumed at its end
    want = tio.VisData.from_uvh5(str(tmp_path / "one_r.uvh5"))
    for tag in ("w", "again"):
        got = tio.VisData.from_uvh5(str(tmp_path / f"{tag}_r.uvh5"))
        np.testing.assert_array_equal(got.flag_array, want.flag_array)
        assert (np.max(np.abs(got.data_array - want.data_array))
                <= 1e-9 * np.max(np.abs(want.data_array)))
