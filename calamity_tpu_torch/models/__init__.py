"""Foreground model families: smooth-frequency bases and baseline grouping.

- dpss: Slepian (DPSS) delay-limited basis (reference modeling.py:255-301)
- dft: DFT delay-mode basis (reference README.md:6 basis class)
- simple_cov: analytic multi-baseline covariance eigenbasis
  (reference simple_cov.py)
- redundancy / overlap: baseline grouping (reference modeling.py:10-252)
- components: per-group modeling-vector generation (reference modeling.py:255-474)
"""

from .components import (
    yield_dpss_model_comps_bl_grp,
    yield_dft_model_comps_bl_grp,
    yield_mixed_comps,
    yield_pbl_dpss_model_comps,
    yield_pbl_model_comps,
)
from .dft import dft_operator
from .dpss import dpss_basis, dpss_operator
from .overlap import get_uv_overlapping_grps_conjugated
from .redundancy import get_redundant_grps_data
from .simple_cov import simple_cov_matrix, yield_simple_multi_baseline_model_comps

__all__ = [
    "dpss_operator",
    "dpss_basis",
    "dft_operator",
    "simple_cov_matrix",
    "yield_simple_multi_baseline_model_comps",
    "get_redundant_grps_data",
    "get_uv_overlapping_grps_conjugated",
    "yield_dpss_model_comps_bl_grp",
    "yield_dft_model_comps_bl_grp",
    "yield_pbl_model_comps",
    "yield_pbl_dpss_model_comps",
    "yield_mixed_comps",
]
