"""Peaks of the card and the least time of each counted kernel's work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W). A bound is the larger of the bytes the work must move (each input
read once, each output written once) over the memory rate and its
operations over the unit that runs them; a roofline share is a bound over
the measured time. The counts are frozen copies of the bounds the port's
smoke test held its kernels to (``chip_smoke.py``: ``_shared_bound``,
``_products_bound``, ``_grad_bound``, ``_adamax_bound_ms``,
``_carry_bound_ms``), as functions of the frozen layout
(:mod:`layout`), so that they read the same work whatever implements it.
Every function returns milliseconds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores


def _ms(moved, t_ops):
    return max(1e3 * moved / HBM_BYTES_PER_S, t_ops)


def shared_chunk_ms(chunk, nbatch, nfreqs, comps_itemsize, wgts_itemsize):
    """One step of the shared-basis chunk loss with every gradient: comps
    and the coefficients read once, the valid groups' planes (gain
    products, data, weights) read once, the losses, dpr, dpi and dcoeffs
    written once; per valid entry 4 V multiply-adds of each product (the
    model and the coefficient contraction) on the tensor cores at the
    TF32 rate, over the split products each takes (3 for float32 comps, 2
    for bfloat16), and 28 other operations at the float32 rate, the two
    units side by side."""
    entries = nbatch * chunk.valid * nfreqs
    coeffs = 2 * nbatch * chunk.groups * chunk.nvecs * 4
    planes = nbatch * chunk.groups * nfreqs * 4
    moved = (chunk.nu * nfreqs * chunk.nvecs * comps_itemsize + coeffs
             + entries * (16 + wgts_itemsize) + 4 * nbatch + 2 * planes + coeffs)
    products = 3 if comps_itemsize == 4 else 2
    t_mma = 1e3 * 2 * entries * 4 * chunk.nvecs * products / TF32_FLOPS
    t_f32 = 1e3 * entries * 28 / F32_FLOPS
    return _ms(moved, max(t_mma, t_f32))


def gain_products_ms(chunk, nbatch, nants, nfreqs, itemsize=4):
    """The gain products of a chunk's valid rows: pr and pi written once,
    the gains and both index lists read once; 6 operations a value."""
    rows = chunk.valid
    moved = itemsize * nbatch * nfreqs * (2 * rows + 2 * nants) + 8 * rows
    return _ms(moved, 1e3 * 6 * nbatch * rows * nfreqs / F32_FLOPS)


def gain_grad_ms(chunk, nbatch, nants, nfreqs, itemsize=4):
    """The gain gradient of a chunk's valid rows: their cotangents and the
    gains read once, dg written once; 8 operations an entry and channel,
    two entries a row."""
    rows = chunk.valid
    moved = itemsize * nbatch * nfreqs * (2 * rows + 4 * nants)
    return _ms(moved, 1e3 * 8 * 2 * rows * nfreqs * nbatch / F32_FLOPS)


def adamax_ms(elements, improved, itemsize=4):
    """One update of ``elements`` parameters: p, g, mu and nu read, p, mu
    and nu written (28 bytes a float32 element); ``improved`` of them (the
    rows whose loss improved) also write their best copy."""
    return 1e3 * itemsize * (7 * elements + improved) / HBM_BYTES_PER_S


def carry_ms(nbatch, itemsize=4):
    """One carry update: the counters and losses it reads and writes (the
    serial carry at ``nbatch`` None)."""
    if nbatch is None:
        return 1e3 * (7 * 8 + 8 * itemsize) / HBM_BYTES_PER_S
    return 1e3 * (7 * 8 + nbatch * (1 + 3 * itemsize + 8 + 4 + 2 * itemsize + 8)) / HBM_BYTES_PER_S


def leaf_elements(chunks, nants, nfreqs):
    """Parameters of one slice: the gains' real and imaginary parts and
    every chunk's coefficients, as packed."""
    return 2 * nants * nfreqs + 2 * sum(c.groups * c.nvecs for c in chunks)
