"""The full-HERA configuration (``scripts/hera_full_demo_torch.py``, the
port of ``examples/hera_full_demo.py``) at cut size, through the port and
through the JAX package with the same flags and seeds.

rings 2 (19 antennas, 171 baselines, 30 unique spacings) and rings 3 (37,
666, 63) at 64 channels. The JAX side is built with the JAX package's host
layer step by step as the example builds it. Checked: the two builds are
equal to the bit (antenna positions, baselines, data, flags, the
component dict) and pack the same chunks; a float64 serial fit with the
demo's arguments (shared-basis packing, ``nvec_bucketing``, ``remat``,
post_hoc, lr 1e-2, tol 1e-11, patience 500 with use_min) agrees as the
HERA core's does (``tests/test_torch_hera_core.py``): loss histories to
rel 1e-10 over the first 1000 steps, gains within rel 1e-4 of their peak,
models within 1e-6 and corrected resids within 1e-5 of the model's peak;
a float64 time-parallel fit of 2 times with 5% RFI flags, bfloat16
weights and loss blocks, 600 steps (short of the floor, where rounding
differences grow: at 2000 steps the histories end rel 2e-4 apart), agrees
to rounding (histories to rel 1e-10, gains to 1e-12 of their peak, models
and resids, stored as complex64, to 1e-8 of the model's peak: the same
arithmetic in float64 on the same rounded weights); the prep cache
round-trips (a reload equals a fresh build, a cache of 2 times serves 1,
a different configuration exits naming it); and the script, run in a
fresh interpreter, loads neither jax nor ``calamity_tpu``. A ``gpu`` case
holds the shared-basis kernel at the full array's six phase 3s chunk
shapes against its plain version on the card.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from calamity_tpu import cal_utils as jcal_utils
from calamity_tpu import calibration as jcalibration
from calamity_tpu import models as jmodels
from calamity_tpu import simulate as jsimulate
from calamity_tpu.io.visdata import VisData as JVisData
from calamity_tpu.solver.tensorize import FitSpec as JFitSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import hera_core_demo_torch as core  # noqa: E402
import hera_full_demo_torch as demo  # noqa: E402

NFREQS = 64
RMS = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731


def _example():
    """``examples/hera_full_demo.py`` as a module (its top level imports
    only argparse, sys, time and numpy)."""
    spec = importlib.util.spec_from_file_location(
        "hera_full_demo_example", os.path.join(REPO, "examples", "hera_full_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_build(rings, pitch=14.6, nfreqs=NFREQS, nsrc=50, ntimes=1, data_dtype="complex64"):
    """The example's preparation with the JAX package's host layer, step by
    step: (corrupted VisData, comps dict, distinct operators)."""
    rng = np.random.default_rng(13)
    antpos = _example().hex_lattice(rings, pitch)
    nants = len(antpos)
    iu, ju = np.triu_indices(nants, k=1)
    vecs = antpos[ju] - antpos[iu]
    nbls = len(vecs)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    freqs = 100e6 + 100e3 * np.arange(nfreqs)
    vis_uniq = jsimulate.point_source_visibilities(uniq, freqs, nsrc=nsrc, seed=1)
    cache = {}
    lengths = np.linalg.norm(uniq, axis=1)
    for u in range(len(uniq)):
        mat = jmodels.yield_dpss_model_comps_bl_grp(lengths[u], freqs, min_dly=10.0,
                                                    offset=10.0, operator_cache=cache)
        vis_uniq[u] = mat @ (mat.T @ vis_uniq[u])
    data = vis_uniq[inverse.reshape(-1)]
    uvd = JVisData(
        telescope_name="HERA-FULL-SIM",
        instrument="HERA-FULL-SIM",
        latitude=jsimulate.HERA_LAT,
        longitude=jsimulate.HERA_LON,
        altitude=jsimulate.HERA_ALT,
        channel_width=100e3,
        ant_1_array=np.tile(iu, ntimes).astype(np.int64),
        ant_2_array=np.tile(ju, ntimes).astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=jsimulate._enu_to_ecef_rel(antpos, jsimulate.HERA_LAT,
                                                     jsimulate.HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls * ntimes, 10.7),
        lst_array=np.zeros(nbls * ntimes),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.repeat(2459122.25 + 2.0 * np.arange(ntimes), nbls),
        uvw_array=np.tile(vecs, (ntimes, 1)),
        data_array=np.tile(data[:, None, :, None], (ntimes, 1, 1, 1)).astype(
            np.dtype(data_dtype)),
        flag_array=np.zeros((nbls * ntimes, 1, nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nbls * ntimes, 1, nfreqs, 1), dtype=np.float32),
    )
    comps = jmodels.yield_pbl_dpss_model_comps(uvd, min_dly=10.0, offset=10.0,
                                               operator_cache=cache)
    truth = jcal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    return jcal_utils.apply_gains(uvd, truth, inverse=True), comps, len(cache)


def jax_rfi_flags(corrupted, frac):
    """The example's RFI bands (``run_fit``), on a JAX-package VisData."""
    frng = np.random.default_rng(99)
    nf = corrupted.Nfreqs
    target = int(frac * nf)
    flagged = np.zeros(nf, dtype=bool)
    while flagged.sum() < target:
        c = int(frng.integers(0, nf))
        w = int(frng.integers(2, 24))
        flagged[max(0, c - w // 2): c + w // 2 + 1] = True
    corrupted.flag_array[:, :, flagged, :] = True
    return flagged


def jax_fit(corrupted, comps, maxsteps=2000, dtype=np.float32, **kw):
    """The example's ``calibrate_and_model_dpss`` call (``run_fit``)."""
    kw = dict(dict(comps_precision=None, wgts_precision="float32", time_parallel=False,
                   loss_block_ngrps=None, patience=500), **kw)
    return jcalibration.calibrate_and_model_dpss(
        uvdata=corrupted, gains=None, fg_model_comps_dict=comps, maxsteps=maxsteps, tol=1e-11,
        learning_rate=1e-2, correct_resid=True, correct_model=True,
        model_regularization="post_hoc", nvec_bucketing=True, remat=True,
        init_guesses_from_previous_time_step=False, mesh=None, timings={},
        checkpoint_dir=None, checkpoint_every=1000, steps_per_execution=None,
        use_min=kw["patience"] > 0, dtype=dtype, **kw)


def _equal(a, b):
    """Recursive equality: arrays bit for bit (same dtype and shape),
    containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


def _same_visdata(a, b):
    assert sorted(vars(a)) == sorted(vars(b))
    for name in vars(a):
        assert _equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture(scope="module")
def built():
    """Both packages' builds at rings 2 and 3 (one time)."""
    return {rings: (demo.build(rings=rings, nfreqs=NFREQS), jax_build(rings))
            for rings in (2, 3)}


@pytest.mark.parametrize("rings, counts", [(2, (19, 171, 30)), (3, (37, 666, 63))])
def test_build_equals_the_examples(built, rings, counts):
    (corrupted, comps, facts), (jcorrupted, jcomps, jnops) = built[rings]
    assert np.array_equal(demo.hex_lattice(rings, 14.6), _example().hex_lattice(rings, 14.6))
    assert (facts["nants"], facts["nbls"], facts["nuniq"]) == counts
    assert facts["noperators"] == jnops
    # positions, baselines, data, flags and nsamples, every attribute
    _same_visdata(corrupted, jcorrupted)
    assert corrupted.data_array.dtype == np.complex64
    assert _equal(comps, jcomps)


@pytest.mark.parametrize("rings", [2, 3])
def test_both_packages_pack_the_same_chunks(built, rings):
    (corrupted, comps, _), (jcorrupted, jcomps, _) = built[rings]
    layouts = core.chunk_layouts(corrupted, comps)
    assert {c["kind"] for c in layouts} <= {"shared", "shared-batched"}
    ants = {int(a): i for i, a in enumerate(
        sorted(set(jcorrupted.ant_1_array) | set(jcorrupted.ant_2_array)))}
    jspec = JFitSpec(jcorrupted, jcomps, ants, nvec_bucketing=True, shared_basis=True)
    want = [(tuple(c.comps.shape), c.a0.shape[0]) for c in jspec.chunks]
    got = [((c["U"], c["B"], c["F"], c["V"]), c["groups"]) for c in layouts]
    assert got == want


def test_serial_fit_matches_the_jax_package_in_float64(built):
    (corrupted, comps, _), (jcorrupted, jcomps, _) = built[2]
    tm, tr, tg, th = demo.fit(corrupted, comps, device="cpu", dtype=np.float64)
    jm, jr, jg, jh = jax_fit(jcorrupted, jcomps, dtype=np.float64)
    ht, hj = np.asarray(th[0][0]["loss"]), np.asarray(jh[0][0]["loss"])
    assert abs(len(ht) - len(hj)) <= 2 and len(hj) > 1000
    assert np.max(np.abs(ht[:1000] - hj[:1000]) / np.abs(hj[:1000])) <= 1e-10
    assert np.max(np.abs(tg.gain_array - jg.gain_array)) <= 1e-4 * np.max(np.abs(jg.gain_array))
    peak = np.max(np.abs(jm.data_array))
    assert np.max(np.abs(tm.data_array - jm.data_array)) <= 1e-6 * peak
    assert np.max(np.abs(tr.data_array - jr.data_array)) <= 1e-5 * peak
    assert RMS(corrupted.data_array) >= 1e3 * RMS(tr.data_array)


def test_time_parallel_rfi_bf16_weights_and_loss_blocks_match_the_jax_package():
    """Two times, 5% of the channels flagged in bands, bfloat16 weights and
    loss blocks of 32 groups (two of rings 2's five chunks split), float64,
    600 steps: the same descent in both packages."""
    corrupted, comps, _ = demo.build(rings=2, nfreqs=NFREQS, ntimes=2)
    jcorrupted, jcomps, _ = jax_build(2, ntimes=2)
    flagged = demo.rfi_flags(corrupted, 0.05)
    assert np.array_equal(flagged, jax_rfi_flags(jcorrupted, 0.05))
    assert flagged.sum() >= int(0.05 * NFREQS)
    kw = dict(time_parallel=True, wgts_precision="bfloat16", loss_block_ngrps=32, maxsteps=600)
    timings = {}
    tm, tr, tg, th = demo.fit(corrupted, comps, device="cpu", dtype=np.float64, timings=timings,
                              **kw)
    jm, jr, jg, jh = jax_fit(jcorrupted, jcomps, dtype=np.float64, **kw)
    assert {"extract_s", "descent_s", "writeback_s", "writeback_rss_gib"} <= set(timings)
    for t in (0, 1):
        ht, hj = np.asarray(th[0][t]["loss"]), np.asarray(jh[0][t]["loss"])
        assert len(ht) == len(hj) == 600
        assert np.max(np.abs(ht - hj) / np.abs(hj)) <= 1e-10
    np.testing.assert_array_equal(tg.flag_array, jg.flag_array)
    np.testing.assert_array_equal(tr.flag_array, jr.flag_array)
    assert np.max(np.abs(tg.gain_array - jg.gain_array)) <= 1e-12 * np.max(np.abs(jg.gain_array))
    peak = np.max(np.abs(jm.data_array))
    assert np.max(np.abs(tm.data_array - jm.data_array)) <= 1e-8 * peak
    assert np.max(np.abs(tr.data_array - jr.data_array)) <= 1e-8 * peak
    good = ~corrupted.flag_array
    assert RMS(corrupted.data_array[good]) >= 1e2 * RMS(tr.data_array[good])


def test_prep_cache_round_trips(tmp_path):
    cache = str(tmp_path / "prep")
    argv = ["--rings", "2", "--nfreqs", str(NFREQS), "--ntimes", "2", "--device", "cpu",
            "--prep_cache", cache]
    with pytest.raises(SystemExit, match="requires --prep_cache"):
        demo.main(argv[:-2] + ["--prep_only"])
    demo.main(argv + ["--prep_only"])
    assert sorted(os.listdir(cache)) == ["comps.npy", "corrupted.uvh5", "meta.npz"]
    demo.main(argv + ["--prep_only"])  # a present cache: nothing to do
    fresh, fresh_comps, fresh_facts = demo.build(rings=2, nfreqs=NFREQS, ntimes=2)
    loaded, comps, facts = demo.prepare(rings=2, nfreqs=NFREQS, ntimes=2, prep_cache=cache)
    assert facts["nbls"] == fresh_facts["nbls"] == 171 and facts["noperators"] == 9
    assert _equal(comps, fresh_comps)
    names = ("data_array", "flag_array", "nsample_array", "ant_1_array", "ant_2_array",
             "time_array", "uvw_array", "freq_array", "antenna_positions", "polarization_array")
    for name in names:
        assert _equal(getattr(loaded, name), getattr(fresh, name)), name
    # a cache of 2 times serves a run of 1: its leading time
    first, _, _ = demo.prepare(rings=2, nfreqs=NFREQS, ntimes=1, prep_cache=cache)
    fresh.select(times=np.unique(fresh.time_array)[:1], inplace=True)
    assert first.Ntimes == 1
    for name in names:
        assert _equal(getattr(first, name), getattr(fresh, name)), name
    for bad, named in ((dict(ntimes=3), "'ntimes': (3, 2)"), (dict(nsrc=20), "'nsrc': (20, 50)"),
                       (dict(rings=3), "'rings': (3, 2)")):
        kw = dict(dict(rings=2, nfreqs=NFREQS, ntimes=2), **bad)
        with pytest.raises(SystemExit, match="different configuration") as err:
            demo.prepare(prep_cache=cache, **kw)
        assert named in str(err.value)


def test_script_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The script at cut size on the CPU, in a fresh interpreter: it fits,
    prints the demo's table and never loads jax or calamity_tpu."""
    script = os.path.join(REPO, "scripts", "hera_full_demo_torch.py")
    argv = ["--device", "cpu", "--rings", "2", "--nfreqs", "32", "--maxsteps", "30",
            "--time_parallel", "--ntimes", "2", "--loss_block_ngrps", "32"]
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{script!r}] + {argv!r}\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'calamity_tpu')\n"
        "             or m.startswith(('jax.', 'calamity_tpu.')))\n"
        "print(json.dumps({'loaded': bad, 'port': 'calamity_tpu_torch' in sys.modules}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, TQDM_DISABLE="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"loaded": [], "port": True}
    assert any(line.startswith("=== full-HERA demo (port): 19 ants / 171 baselines")
               for line in lines)
    assert any(line.startswith("write-back:") for line in lines)


# the full array's six chunk shapes that phase 3s of chip_smoke.py times,
# (U, gmax, V) at 1536 channels: the heaviest and the narrowest
FULL_ARRAY_SHAPES = ((22, 1024, 256), (24, 512, 256), (10, 2048, 128), (4, 256, 512),
                     (9, 64, 512), (3, 16, 512))


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FULL_ARRAY_SHAPES)
def test_cuda_kernel_matches_plain_at_the_full_arrays_chunks(shape, comps_dtype):
    """The shared-basis kernel at one of the full array's chunks, N = 1,
    float32 and bfloat16 comps, the last group of each class padding: every
    chi-square instance and every "sum" instance (its forward; its
    backwards at random cotangents) against its plain version (loss and
    terms rel 1e-5, M_r and M_i against sum w|m|, gradients rel 1e-4), two
    launches equal to the bit, the padding's gradients zero. Its launch
    plan at N = 1 and 8: within a block's 227 KB of shared memory and a
    cluster of 16, the sliced design's shared memory and blocks an SM
    (``chip_smoke.SLICED_SMEM``, ``SLICED_BLOCKS``), ceil(V / 64) mode slices
    times the channel splits on each tile of 32 pairs; at N = 1 a V = 512
    chunk at least 8 blocks a tile."""
    from calamity_tpu_torch.ops import _build, fused, shared

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sys.path.insert(0, REPO)
    import chip_smoke

    dev = torch.device("cuda")
    nu, gmax, nv = shape
    ngrps, nf = nu * gmax, 1536
    for nbatch in (1, 8):
        plan = _build.load_kernels().shared_plan(nbatch, ngrps, nf, nv, nu,
                                                 int(comps_dtype == "bfloat16"), fused.LOSS_ALL)
        pair_tiles = -(-(gmax * nbatch) // 32) * nu
        assert plan["smem_bytes"] == chip_smoke.SLICED_SMEM[comps_dtype] <= 227 * 1024
        assert plan["blocks_per_sm"] == chip_smoke.SLICED_BLOCKS[comps_dtype]
        assert plan["slices"] == -(-nv // 64)
        assert plan["cluster"] == plan["slices"] * plan["splits"] <= 16
        assert plan["grid"] == pair_tiles * plan["cluster"]
        if nv == 512 and nbatch == 1:
            assert plan["grid"] >= 8 * pair_tiles
    rng = np.random.default_rng(nu + gmax + nv)
    valid = np.ones(ngrps, bool)
    valid[gmax - 1::gmax] = False
    mask = torch.as_tensor(valid, device=dev)

    def t(*s):
        return torch.as_tensor(rng.standard_normal(s, dtype=np.float32), device=dev)

    comps3 = t(nu, nf, nv)
    comps3 /= torch.linalg.vector_norm(comps3, dim=1, keepdim=True)
    w = t(1, ngrps, nf).abs() * mask.reshape(1, -1, 1)
    args = [t(2, 1, ngrps, nv), 1 + 0.1 * t(1, ngrps, nf), 0.1 * t(1, ngrps, nf),
            t(1, ngrps, nf), t(1, ngrps, nf), w / w.sum(), comps3.to(getattr(torch, comps_dtype))]
    cot = t(3, 1)
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL, fused.SUM_FWD, fused.SUM_DP,
                 fused.SUM_ALL):
        c = cot if mode in (fused.SUM_DP, fused.SUM_ALL) else None
        got = shared.loss_and_grads_kernel(*args, mask, mode, c)
        again = shared.loss_and_grads_kernel(*args, mask, mode, c)
        want = shared.loss_and_grads_plain(*args, mask, mode, c)
        torch.cuda.synchronize()
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))
        if mode == fused.SUM_FWD:
            # M_r and M_i relative to sum w|m|, as chip_smoke.py holds them
            scale = chip_smoke.flux_scale(args, mask)
            assert float((got[0][0] - want[0][0]).abs().max() / want[0][0].abs().max()) <= 1e-5
            assert float(((got[0][1:] - want[0][1:]).abs() / scale).max()) <= 1e-5
        elif want[0] is not None:
            assert float(((got[0] - want[0]).abs() / want[0].abs()).max()) <= 1e-5
        for g, p in zip(got[1:], want[1:]):
            assert (g is None) == (p is None)
            if p is not None:
                assert float((g - p).abs().max() / p.abs().max()) <= 1e-4
        if got[2] is not None:
            assert not bool(got[2][:, ~mask].any())
        if got[1] is not None:
            assert not bool(got[1][:, :, ~mask].any())

