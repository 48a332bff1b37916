"""The dense packing the dense loss kernel's roofline counts, frozen as a function of the deployment.

A deployment fitted with per-baseline bases (``shared_basis`` off) gives
every baseline its own copy of its operator's basis. The count takes the
least work of that: one dense chunk an operator, whose groups are the
operator's baselines, each with its own basis at the operator's own mode
count. It reads the deployment's operators (:func:`operators`), never the
program.

The port packs the operators' baselines into buckets at the bucket's
largest mode count: on the HERA core 684 baselines at 29 modes and 3704 at
61, 245,780 basis columns where this count has 202,174 (684 x 29, 648 x 35,
646 x 45, 1224 x 49, 578 x 58, 608 x 61). Its bases are therefore 21.6%
more bytes than this bound's, and a share of the bound reads the padding
as time lost.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from calbench import arrays, dpss, roofline

# the configuration this count is frozen for: the one cell that packs dense chunks
CONFIG = "hera_core_dense"


class DenseChunk(NamedTuple):
    groups: int  # baselines, each with its own basis
    nvecs: int  # modes


def operators(name, nfreqs=None):
    """The mode count of each operator of configuration ``name`` and the
    baselines each serves, at ``nfreqs`` channels (the configuration's by
    default), as the harness builds them."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{name}.json")
    with open(path) as f:
        cfg = json.load(f)
    dep = arrays.build(cfg, nfreqs)
    ops = dpss.operators(dep.freqs, dep.op_dly_ns, cutoff=cfg["basis"]["eigenval_cutoff"])
    return [a.shape[1] for a in ops], np.bincount(dep.op_of_bl, minlength=len(ops))


def chunks(op_nvecs, op_sizes):
    """The dense chunks of a deployment whose operator k has ``op_nvecs[k]``
    modes and serves ``op_sizes[k]`` baselines, in the operators' order."""
    return [DenseChunk(int(g), int(v)) for v, g in zip(op_nvecs, op_sizes) if g]


def loss_ms(chunk, nbatch, nfreqs, comps_itemsize, wgts_itemsize):
    """One step of the dense chunk loss with every gradient, counted as the
    port's smoke test counts it (``chip_smoke.bound(args, True)``): each
    input read once (the basis at ``comps_itemsize`` bytes, the
    coefficients, the gain products and the data in float32, the weights
    at ``wgts_itemsize``), the losses, dpr, dpi and dcoeffs written once;
    per entry 8 V + 28 operations (the matvec and the coefficient
    contraction, 4 V each, and the model, residual, square and gradients)
    at the float32 rate."""
    rows = nbatch * chunk.groups * nfreqs
    coeffs = 2 * nbatch * chunk.groups * chunk.nvecs * 4
    basis = chunk.groups * nfreqs * chunk.nvecs * comps_itemsize
    moved = (coeffs + 4 * rows * 4 + rows * wgts_itemsize + basis + 4 * nbatch
             + 2 * rows * 4 + coeffs)
    flops = 8 * rows * chunk.nvecs + 28 * rows
    return max(1e3 * moved / roofline.HBM_BYTES_PER_S, 1e3 * flops / roofline.F32_FLOPS)
