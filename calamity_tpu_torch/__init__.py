"""calamity_tpu_torch: the PyTorch/CUDA port of calamity_tpu.

The calibration paths of ``calamity_tpu`` (file read, per-baseline DPSS,
DFT or mixed components, ``FitSpec`` packing, Cholesky warm start, descent
with any optimizer of the reference registry, uvh5/calfits write-back),
serial, batched over (time, pol) slices and as the warm-started time scan
(``parallel``), with checkpointed fits, in PyTorch, with the chunk losses
as hand-written CUDA kernels for Hopper: the fused dense-chunk loss
(``csrc/fused_chunk_loss.cu``), which reads the basis once for every
slice, and the shared-basis chunk loss (``csrc/shared_chunk_loss.cu``),
which reads one operator's tile once for many groups.

The JAX package stays the reference, and this package imports nothing of
it and never imports ``jax``: it carries its own copies of the JAX-free
host layer (``io``, ``models``, ``cal_utils``, ``utils``, ``version``,
``simulate``), numpy and scipy as in the JAX package. Where ``h5py`` is not
installed, ``_h5lite`` (a minimal pure-Python HDF5 reader/writer) is
registered under its name before the host layer is imported; the tests of
both packages rely on that on a machine without h5py.
"""

import sys

from ._device import LAUNCHES, resolve_device, set_float_policy

set_float_policy()

try:
    import h5py  # noqa: F401
except ImportError:
    # the host layer's file I/O imports h5py at module level; where it is
    # not installed, the package's minimal HDF5 reader/writer stands in
    from . import _h5lite

    sys.modules["h5py"] = _h5lite

__all__ = ["LAUNCHES", "resolve_device", "set_float_policy"]
