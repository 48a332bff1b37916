"""The harness rehearsed on the CPU at cut width: the result line, the
checks on the card and on JAX, and what a sound run reads."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from calbench_cuts import CUTS, ROOT, SEED

from calbench import harness

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", sorted(CUTS))
@pytest.mark.parametrize("traced", [False, True])
def test_rehearsal_prints_the_contracts_line(name, traced):
    code, res = harness.run(name, SEED, 0.0, traced, time.perf_counter(), device="cpu",
                            overrides=CUTS[name])
    assert code == 0
    assert set(res) == CONTRACT | {"compared"} and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    cell = harness.Cell(name)
    if traced:
        # on the CPU only the host's clock reads: the device's readers find nothing
        assert set(res["metrics"]) == {"pack_s"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(res)


def run_py(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "calbench/run.py", "--workload", "hera_core.fit1",
                           "--seed", str(SEED), "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_without_a_card_fails_and_prints_no_result():
    res = run_py(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA card" in res.stderr


def test_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "calbench"), tmp_path / "calbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    res = run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
from calbench import harness
from calbench_cuts import CUTS
code, res = harness.run("hera_full.fit1", 5, 0.0, False, time.perf_counter(), device="cpu",
                        overrides=CUTS["hera_full.fit1"])
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from calbench import arrays, dpss, reference, sky
cfg = json.load(open({cfg!r}))
cfg["array"]["rings"] = 2
dep = arrays.build(cfg, nfreqs=64)
ops = [torch.as_tensor(a) for a in dpss.operators(dep.freqs, dep.op_dly_ns, workers=1)]
vis = sky.unique_vis(dep, sky.draw_sky(1, 50), ops, torch.device("cpu"))
g = sky.draw_gains(1, 1, dep.nants, dep.nfreqs, 0.03, torch.device("cpu"))
data = np.empty((dep.nbls, dep.nfreqs), np.complex64)
sky.slice_into(dep, vis, g[0], data)
s = reference.make_slice(dep, data, np.zeros(64, bool), "float32", torch.device("cpu"))
assert len(reference.follow(s, ops, 3)) == 3
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def top_level_names(script):
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=os.path.join(ROOT, "calbench", "tests"))
    assert res.returncode == 0, res.stderr[-3000:]
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    # top-level names compared whole: the port's name begins with the JAX package's
    names = top_level_names(SCRIPT.format(root=ROOT))
    assert "calamity_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "calamity_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    cfg = os.path.join(ROOT, "calbench", "configs", "hera_full.json")
    names = top_level_names(REFERENCE_ONLY.format(root=ROOT, cfg=cfg))
    assert not names & {"calamity_tpu_torch", "calamity_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.gpu
def test_each_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CUTS:
        code, res = harness.run(name, SEED, 1.0, False, time.perf_counter())
        assert code == 0 and res["correct"] and res["device"]["platform"] == "gpu"
