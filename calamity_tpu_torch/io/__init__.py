"""Host-side I/O boundary: visibility / gain / flag containers + file formats.

This layer replaces the reference's external pyuvdata dependency
(reference calibration.py:3) with in-repo, numpy-backed containers. It is
deliberately thin: everything device-side works on dense tensors produced
by calamity_tpu_torch.solver.tensorize. A copy of calamity_tpu.io: the
port reads and writes the same files without importing the JAX package.
"""

from .caldata import CalData
from .flags import FlagWeights
from .polarizations import jstr2num, polnum2str, polstr2num
from .visdata import VisData

__all__ = [
    "CalData",
    "FlagWeights",
    "VisData",
    "polstr2num",
    "polnum2str",
    "jstr2num",
]
