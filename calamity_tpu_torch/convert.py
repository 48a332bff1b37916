"""Carry the JAX package's arrays and state into the port's tensors.

Turns what ``calamity_tpu`` hands out (jax or numpy arrays, optax states)
into tensors on a given device, so both packages can run from one state:
the ``FitSpec`` chunk triples, the fit parameters ``(g_r, g_i, fg_r,
fg_i)`` and an optax ``adamax`` state. Arrays are read through numpy, so
this module imports neither jax nor optax.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .solver.optimizers import AdamaxState


def to_tensor(x, device):
    """Tensor on ``device`` with the array's values and dtype (bfloat16
    arrays included)."""
    arr = np.array(x)  # a writable copy: jax hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(arr).to(resolve_device(device))


def chunks_from_jax(chunks, device):
    """FitSpec chunk triples (comps, a0, a1) as tensors."""
    return tuple(tuple(to_tensor(x, device) for x in triple) for triple in chunks)


def params_from_jax(g_r, g_i, fg_r=None, fg_i=None, *, device):
    """The fit's parameter tree: ``{"g_r", "g_i"}`` plus per-chunk
    ``"fg_r"``/``"fg_i"`` lists when coefficients are given."""
    params = {"g_r": to_tensor(g_r, device), "g_i": to_tensor(g_i, device)}
    if fg_r is not None:
        params["fg_r"] = [to_tensor(x, device) for x in fg_r]
        params["fg_i"] = [to_tensor(x, device) for x in fg_i]
    return params


def adamax_state_from_optax(opt_state, device):
    """An optax ``adamax`` state (``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, with mu and nu over the reference's parameter tuple
    ``(g_r, g_i[, fg_r, fg_i])``) as the port's ``AdamaxState``."""
    adam = opt_state[0]

    def tree(moments):
        return params_from_jax(*moments, device=device)

    return AdamaxState(count=int(np.asarray(adam.count)), mu=tree(adam.mu), nu=tree(adam.nu))
