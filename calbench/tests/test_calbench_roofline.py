"""The frozen layout and the bounds the rooflines count."""

import json
import os

import numpy as np
import pytest
from calbench_cuts import ROOT

from calbench import arrays, dpss, layout, roofline


def deployment_chunks(name):
    cfg = json.load(open(os.path.join(ROOT, "calbench", "configs", f"{name}.json")))
    dep = arrays.build(cfg)
    nvecs = [a.shape[1] for a in dpss.operators(dep.freqs, dep.op_dly_ns)]
    return layout.chunks(nvecs, np.bincount(dep.op_of_bl)), dep


@pytest.fixture(scope="module")
def full():
    return deployment_chunks("hera_full")


def test_full_array_layout(full):
    chunks, dep = full
    assert len(chunks) == 18
    assert sum(c.groups for c in chunks) == 77748
    assert sum(c.valid for c in chunks) == dep.nbls == 54615
    shapes = {(c.nu, c.gmax, c.nvecs) for c in chunks}
    # the six heaviest and narrowest chunks the port's smoke test times
    assert {(22, 1024, 256), (24, 512, 256), (10, 2048, 128), (4, 256, 512), (9, 64, 512),
            (3, 16, 512)} <= shapes
    # 38 leaves, 33.3M elements a slice, as the port's Adamax kernel counts them
    assert roofline.leaf_elements(chunks, dep.nants, dep.nfreqs) == 33281024


@pytest.mark.parametrize("nbatch, itemsize, ms", [(1, 4, 1.0150), (1, 2, 0.8997),
                                                   (8, 4, 8.0397), (8, 2, 7.0508)])
def test_full_array_step_bound_reproduces_the_smoke_tests(full, nbatch, itemsize, ms):
    chunks, dep = full
    got = sum(roofline.shared_chunk_ms(c, nbatch, dep.nfreqs, itemsize, 4) for c in chunks)
    assert round(got, 4) == ms


def test_hera_core_layout():
    chunks, dep = deployment_chunks("hera_core")
    assert sorted((c.nu, c.gmax, c.nvecs) for c in chunks) == sorted(
        [(1, 1024, 32), (3, 1024, 64), (1, 2048, 64), (2, 512, 64)])
    assert sum(c.groups for c in chunks) == 7168 and sum(c.valid for c in chunks) == 4388


def test_adamax_bound_counts_bytes_an_element():
    # 28 bytes an updated float32 element, 32 where the loss improved
    assert roofline.adamax_ms(1000, 0) == pytest.approx(28e3 / 3.35e12 * 1e3)
    assert roofline.adamax_ms(1000, 1000) == pytest.approx(32e3 / 3.35e12 * 1e3)
