"""The port's warm-started time scan sharded over a ('data', 'bl') mesh,
on the CPU, in worlds of 2 and 4 gloo processes
(tests/torch_mesh_worlds.py): groups split over 'bl', 'data' unused.

- On (1, 2), float32, against the JAX package's scan on the same mesh
  shape over its virtual CPU devices (tests/test_parallel.py:235-271), with
  the criteria of tests/test_torch_time_parallel.py:62-73.
- In float64, on (1, 2) and on (2, 2), against the port's unsharded scan:
  the same step counts and histories within rel 1e-9, with the "sum" prior
  and model-SNR weights, a blocked loss and the mixed schedule.

The cut and resumed scan is in tests/test_torch_mesh.py.
"""

import jax
import pytest
from test_torch_mesh import COMMON, F64, _as_outputs, _assert_equal_f64, _same_on_every_rank
from test_torch_time_parallel import _assert_agree
from torch_mesh_worlds import run_world, time_parallel_cases
from torch_parity import as_port, gain_corrupted, multitime_visdata

from calamity_tpu import calibration as jcal
from calamity_tpu import parallel as jparallel
from calamity_tpu_torch import calibration as tcal

SCAN = dict(init_guesses_from_previous_time_step=True)


@pytest.fixture(scope="module")
def corrupted_multitime(golomb_visdata):
    return gain_corrupted(multitime_visdata(golomb_visdata))


def _unsharded(uvd, **kw):
    return tcal.calibrate_and_model_dpss(uvdata=as_port(uvd), device="cpu", time_parallel=True,
                                         **kw)


def test_scan_1x2_against_jax_and_unsharded(corrupted_multitime, tmp_path):
    f32 = dict(COMMON, **SCAN, maxsteps=60)
    cases = [("f32", as_port(corrupted_multitime), f32),
             ("f64", as_port(corrupted_multitime), dict(F64, **SCAN)),
             ("sum_snr", as_port(corrupted_multitime),
              dict(F64, **SCAN, model_regularization="sum", use_model_snr_weights=True)),
             ("block_mixed", as_port(corrupted_multitime),
              dict(F64, **SCAN, loss_block_ngrps=4, comps_precision="mixed", maxsteps=40))]
    results = run_world(time_parallel_cases, 2, tmp_path, (1, 2), cases)
    _same_on_every_rank(results)
    got = results[0]
    mesh = jparallel.make_mesh(n_data=1, n_bl=2, devices=jax.devices()[:2])
    jout = jcal.calibrate_and_model_dpss(uvdata=corrupted_multitime, mesh=mesh,
                                         time_parallel=True, **f32)
    _assert_agree(jout, _as_outputs(got["f32"]), corrupted_multitime)
    for name, _, kw in cases[1:]:
        _assert_equal_f64(got[name], _unsharded(corrupted_multitime, **kw))


def test_scan_2x2_leaves_data_unused(corrupted_multitime, tmp_path):
    """On (2, 2) both 'data' rows run the same scan over their 'bl' pair."""
    kw = dict(F64, **SCAN, model_regularization="sum")
    results = run_world(time_parallel_cases, 4, tmp_path, (2, 2),
                        [("f64", as_port(corrupted_multitime), kw)])
    _same_on_every_rank(results)
    _assert_equal_f64(results[0]["f64"], _unsharded(corrupted_multitime, **kw))
