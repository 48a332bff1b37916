"""Float policy, device resolution and kernel launch counters.

The port never chooses a device on its own: every entry point takes an
explicit ``device`` and passes it down to the tensors it makes. Asking for
CUDA where there is none raises; nothing moves to the CPU unless the caller
asked for the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def set_float_policy():
    """Full float32 in every matmul and convolution.

    The reference computes its float32 contractions at
    ``Precision.HIGHEST`` (calamity_tpu/ops/loss.py:40-43). TF32 keeps about
    three decimal digits and would move the chi-square floor of the fit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device):
    """``torch.device`` for a device name, checked against this machine.

    ``device`` is required (no default): "cpu", "cuda", "cuda:N" or a
    ``torch.device``. A CUDA device that is not present raises."""
    if device is None:
        raise ValueError("device is required: pass 'cuda' or 'cpu' explicitly")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev


class LaunchCounter:
    """Counts of hand-written kernel launches, by kernel name.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its main path went through the kernels. A CUDA graph
    launches what its capture recorded each time it is replayed: the
    wrappers' counts during a capture launched nothing, so
    :meth:`recording` takes them back out and returns them, and
    :meth:`replayed` adds them once per replay."""

    def __init__(self):
        self._counts = {}

    def add(self, name):
        self._counts[name] = self._counts.get(name, 0) + 1

    def get(self, name):
        return self._counts.get(name, 0)

    def reset(self):
        self._counts.clear()

    def counts(self):
        """Every count, by name (a copy)."""
        return dict(self._counts)

    @contextlib.contextmanager
    def recording(self):
        """Within the block, counts go to the dict this yields (the launches
        of one replay of the graph being captured), not to the totals."""
        totals, self._counts = self._counts, {}
        try:
            yield self._counts
        finally:
            self._counts = totals

    def replayed(self, counts, times=1):
        """``times`` replays of a graph whose capture recorded ``counts``."""
        for name, n in counts.items():
            self._counts[name] = self._counts.get(name, 0) + n * times


LAUNCHES = LaunchCounter()
