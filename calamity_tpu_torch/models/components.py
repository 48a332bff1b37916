"""Foreground modeling-component generation (basis vectors per fitting group).

Behavior parity with reference modeling.py:255-474. A "fitting group" is a
tuple of redundant groups (tuples of antenna pairs) that share modeling
components. Values are float64 (Ngrp_bls * Nfreqs, Ncomponents) matrices.
"""

from __future__ import annotations

import datetime

import numpy as np

from ..utils import PBARS, echo
from . import simple_cov
from .dft import dft_operator
from .dpss import dpss_operator
from .redundancy import get_redundant_grps_data


def yield_dpss_model_comps_bl_grp(
    length,
    freqs,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    operator_cache=None,
    eigenval_cutoff=1e-10,
):
    """Per-baseline DPSS vectors for one baseline length.

    The delay half-width follows the reference's horizon formula
    (modeling.py:293): ceil(max(min_dly, length/0.3 * horizon + offset)) ns.
    """
    if operator_cache is None:
        operator_cache = {}
    dly = np.ceil(max(min_dly, length / 0.3 * horizon + offset)) / 1e9
    amat, _ = dpss_operator(
        freqs, filter_half_width=dly, eigenval_cutoff=eigenval_cutoff, cache=operator_cache
    )
    return np.asarray(amat, dtype=np.float64)


def yield_dft_model_comps_bl_grp(
    length,
    freqs,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    operator_cache=None,
    fundamental_period=None,
):
    """Per-baseline DFT (delay-mode) vectors — the DFT basis variant."""
    if operator_cache is None:
        operator_cache = {}
    dly = np.ceil(max(min_dly, length / 0.3 * horizon + offset)) / 1e9
    return dft_operator(
        freqs, filter_half_width=dly, fundamental_period=fundamental_period, cache=operator_cache
    )


_PBL_BASIS_FNS = {
    "dpss": yield_dpss_model_comps_bl_grp,
    "dft": yield_dft_model_comps_bl_grp,
}


def yield_pbl_model_comps(
    visdata,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    include_autos=False,
    use_redundancy=False,
    red_tol=1.0,
    eigenval_cutoff=1e-10,
    notebook_progressbar=False,
    verbose=False,
    basis="dpss",
    operator_cache=None,
):
    """Per-baseline (or per-redundant-group) smooth-basis components.

    Reference parity: modeling.yield_pbl_dpss_model_comps
    (modeling.py:304-374), generalized over the basis type.

    ``operator_cache`` shares operator matrices with a caller that already
    built some (at full-HERA band each distinct delay width costs an
    O(Nfreqs) tridiagonal eigendecomposition — sharing halves setup when a
    simulator or weights pass computed the same operators).

    Returns a dict keyed by 3-level nested tuples
    ``((antpair, ...),)`` -> (Nfreqs, Ncomp) float64 matrix.
    """
    if operator_cache is None:
        operator_cache = {}
    _, red_grps, vec_bin_centers, _ = get_redundant_grps_data(
        visdata, remove_redundancy=not use_redundancy, tol=red_tol, include_autos=include_autos
    )
    fitting_grps = [(tuple(red_grp),) for red_grp in red_grps]
    modeling_vectors = {}
    freqs = np.asarray(visdata.freq_array[0], dtype=np.float64)
    basis_fn = _PBL_BASIS_FNS[basis]
    echo(
        f"{datetime.datetime.now()} Computing {basis.upper()} modeling vectors...\n",
        verbose=verbose,
    )
    # eigenval_cutoff only applies to the DPSS basis (reference forwards it
    # to dspec.dpss_operator, modeling.py:294); the DFT basis has no cutoff
    basis_kwargs = {"eigenval_cutoff": eigenval_cutoff} if basis == "dpss" else {}
    for grpnum in PBARS[notebook_progressbar](range(len(fitting_grps))):
        bllen = np.linalg.norm(vec_bin_centers[grpnum])
        modeling_vectors[fitting_grps[grpnum]] = basis_fn(
            freqs=freqs,
            length=bllen,
            offset=offset,
            horizon=horizon,
            min_dly=min_dly,
            operator_cache=operator_cache,
            **basis_kwargs,
        )
    return modeling_vectors


def yield_pbl_dpss_model_comps(visdata, eigenval_cutoff=1e-10, **kwargs):
    """Reference-named entry point (modeling.py:304)."""
    return yield_pbl_model_comps(visdata, basis="dpss", eigenval_cutoff=eigenval_cutoff, **kwargs)


def yield_mixed_comps(
    fitting_grps,
    fitting_blvecs,
    freqs,
    eigenval_cutoff=1e-10,
    ant_dly=0.0,
    horizon=1.0,
    offset=0.0,
    min_dly=0.0,
    verbose=False,
    dtype=np.float64,
    notebook_progressbar=False,
    use_jax=False,
    grp_size_threshold=5,
    use_torch=False,
    device="cuda",
):
    """Mixed DPSS / low-rank-covariance components per fitting group.

    Reference parity: modeling.yield_mixed_comps (modeling.py:377-474).
    Small groups (<= grp_size_threshold redundant groups) get per-baseline
    DPSS vectors with the antenna chromaticity folded into the offset
    (modeling.py:454); larger groups get eigenvectors of the analytic
    multi-baseline covariance (with ``use_torch``, built and decomposed
    in torch on ``device``).
    """
    operator_cache = {}
    modeling_vectors = {}
    for grpnum in PBARS[notebook_progressbar](range(len(fitting_grps))):
        fit_grp = fitting_grps[grpnum]
        if isinstance(fit_grp, list):
            fit_grp = tuple(fit_grp)
        blvecs = np.atleast_2d(np.asarray(fitting_blvecs[grpnum]))
        bllens = np.linalg.norm(blvecs, axis=1)
        if len(fit_grp) <= grp_size_threshold:
            for red_grp, bllen in zip(fit_grp, bllens):
                # small groups deliberately use offset=ant_dly (NOT the
                # caller's offset) — reference parity, modeling.py:454;
                # large groups' covariance uses both (simple_cov)
                modeling_vectors[(tuple(red_grp),)] = yield_dpss_model_comps_bl_grp(
                    freqs=freqs,
                    length=bllen,
                    offset=ant_dly,
                    horizon=horizon,
                    min_dly=min_dly,
                    operator_cache=operator_cache,
                    eigenval_cutoff=eigenval_cutoff,
                )
        else:
            modeling_vectors[tuple(tuple(rg) for rg in fit_grp)] = (
                simple_cov.yield_simple_multi_baseline_model_comps(
                    blvecs=blvecs,
                    ant_dly=ant_dly,
                    offset=offset,
                    min_dly=min_dly,
                    horizon=horizon,
                    dtype=dtype,
                    freqs=freqs,
                    eigenval_cutoff=eigenval_cutoff,
                    use_jax=use_jax,
                    verbose=verbose,
                    use_torch=use_torch,
                    device=device,
                )
            )
    return modeling_vectors
