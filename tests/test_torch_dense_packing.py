"""The port's dense packing (every baseline its own basis, ``shared_basis``
off) of the HERA core, beside its shared packing and the benchmark's plain
reference, at a cut the CPU fits in seconds.

The core's grid at 5 x 5 (25 antennas, 188 baselines over 7 DPSS
operators), 64 channels, one seeded slice of the benchmark's sky and
gains (``calbench``: ``hera_core`` and ``hera_core_dense`` differ only in
``shared_basis``), 300 steps a phase of the mixed schedule. The two
packings run the same arithmetic in another order (one basis a baseline
against one an operator), so their fits agree to float32 rounding:
measured, the bfloat16 phase's losses to 2.7e-6 relative, the gains to
7e-7, the coefficients to 3.4e-7 of their largest, the reference's
chi-square at the two results to 6.1e-6; each tolerance below is about
ten times that.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from calbench import harness, reference  # noqa: E402
from calamity_tpu_torch._device import SPANS  # noqa: E402

SEED = 2 ** 31 + 12345
CUT = dict(array={"nside": 5}, nfreqs=64, steps=300, warmup_steps=3)
PACKINGS = {"shared": "hera_core.fit1", "dense": "hera_core.dense"}


def setup(cell, overrides=CUT):
    """The benchmark's set-up of ``cell`` at the cut on the CPU, the cycle
    collector given back."""
    try:
        return harness.setup(harness.Cell(cell), SEED, "cpu", overrides, log=lambda *a: None)
    finally:
        harness.release_collector()


@pytest.fixture(scope="module")
def fitted():
    """Per packing: (the fit's output, the reference's chi-square and
    residual ratio at the returned parameters, the coefficients in the
    reference's layout)."""
    out = {}
    for packing, cell in PACKINGS.items():
        ctx = setup(cell)
        res = ctx.fits.fit(0)
        c_r, c_i = reference.gather(ctx.dep, ctx.nvecs, ctx.layout, res.fg_r, res.fg_i, 0)
        sl = reference.make_slice(ctx.dep, ctx.data_ref[:ctx.dep.nbls], ctx.flags,
                                  ctx.wgts_precision, ctx.device)
        loss, resid = reference.judge(sl, ctx.ops, res.g_r[0], res.g_i[0], c_r, c_i)
        out[packing] = (res, loss, resid, (c_r, c_i))
    return out


def test_the_cut_packs_dense_and_shared_chunks():
    dense, shared = setup("hera_core.dense"), setup("hera_core.fit1")
    # every baseline its own basis: the dense chunk's basis has a group axis
    assert [tuple(c.shape) for c, _, _ in dense.fits.chunks] == [(188, 1, 64, 8)]
    # one basis an operator: seven operators over three chunks
    assert sum(c.shape[0] for c, _, _ in shared.fits.chunks) == 7
    assert dense.dep.nbls == shared.dep.nbls == 188


def test_dense_and_shared_packings_fit_alike(fitted):
    (a, _, _, (ar, ai)), (b, _, _, (br, bi)) = fitted["shared"], fitted["dense"]
    assert [len(h) for h in a.hist] == [len(h) for h in b.hist] == [300, 300]
    h0a, h0b = a.hist[0][:, 0], b.hist[0][:, 0]
    assert np.max(np.abs(h0a - h0b) / h0a) <= 3e-5
    assert torch.max(torch.abs(a.g_r - b.g_r)) <= 1e-5
    assert torch.max(torch.abs(a.g_i - b.g_i)) <= 1e-5
    scale = max(float(torch.max(torch.abs(x))) for x in ar + ai)
    gap = max(float(torch.max(torch.abs(x - y))) for x, y in zip(ar + ai, br + bi))
    assert gap <= 4e-6 * scale


def test_both_packings_agree_with_the_reference(fitted):
    losses = {}
    for packing, (res, loss, resid, _) in fitted.items():
        claimed, _ = harness.claimed_loss(res.hist[1][:, 0])
        # the loss the fit claims for its parameters, against the float64
        # reference's chi-square at them (8.5e-6 measured)
        assert abs(claimed - loss) / loss <= 1e-4, packing
        assert resid <= 4e-4, packing  # the cut's limit; 1.66e-4 measured
        losses[packing] = loss
    assert abs(losses["dense"] - losses["shared"]) / losses["shared"] <= 6e-5


def dense_spans():
    return [r for r in SPANS.records() if r.name == "pack.dense"]


def test_each_dense_chunk_is_a_span_with_its_notes():
    # at 128 channels the operators take 7 to 12 modes: two dense chunks,
    # bucketed at 8 and 16 modes and packed at their largest, 8 and 12
    SPANS.reset()
    ctx = setup("hera_core.dense", {**CUT, "nfreqs": 128})
    spans = dense_spans()
    chunks = [c for c, _, _ in ctx.fits.chunks]
    assert len(spans) == len(chunks) == 2
    for span, comps in zip(spans, chunks):
        assert span.end_ns is not None
        assert span.notes == {"groups": comps.shape[0], "nvecs": comps.shape[-1],
                              "bytes": comps.numel() * comps.element_size()}
    assert sorted(s.notes["nvecs"] for s in spans) == [8, 12]
    assert sum(s.notes["groups"] for s in spans) == 188
    fitspec = [r for r in SPANS.records() if r.name == "pack.fitspec"]
    assert len(fitspec) == 1 and all(s.parent == fitspec[0].index for s in spans)
    assert fitspec[0].notes["basis_bytes"] == sum(s.notes["bytes"] for s in spans)


def test_a_shared_fit_records_no_dense_span():
    SPANS.reset()
    ctx = setup("hera_core.fit1")
    assert dense_spans() == []
    fitspec = [r for r in SPANS.records() if r.name == "pack.fitspec"]
    assert fitspec[0].notes["basis_bytes"] == sum(
        c.numel() * c.element_size() for c, _, _ in ctx.fits.chunks)
