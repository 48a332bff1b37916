"""The chunk layout the rooflines count, frozen as a function of the deployment.

The per-layer rooflines count the work of a step from the cell's shapes,
never from the program: the packing rule of the shared-basis fit as it
stood when the benchmark was written, applied to the deployment's
operators. Every baseline is its own fitting group (no redundancy), a
baseline's basis is its operator (one per delay half-width), and with
mode-count bucketing the operators that two or more baselines share are
grouped by (the power of two at or above their mode count, the power of
two at or above their baseline count): a bucket of one operator whose
baseline count is that power of two is a shared chunk of its own modes;
any other bucket is a shared-batched chunk of U operators, each padded to
``gmax`` groups and to the bucket's modes. A chunk's groups are U x gmax,
of which ``valid`` hold a baseline. An operator that one baseline alone
uses would take a dense chunk, which this layout does not count.
"""

from __future__ import annotations

from typing import NamedTuple


class Chunk(NamedTuple):
    nu: int  # operators U
    gmax: int  # groups an operator
    nvecs: int  # modes, as packed
    valid: int  # groups that hold a baseline

    @property
    def groups(self):
        return self.nu * self.gmax


def _pow2(n, start=1):
    b = start
    while b < n:
        b *= 2
    return b


def chunks(op_nvecs, op_sizes):
    """The chunks of a deployment whose operator k has ``op_nvecs[k]`` modes
    and serves ``op_sizes[k]`` baselines."""
    first = {}
    for k, (nv, size) in enumerate(zip(op_nvecs, op_sizes)):
        if size < 2:
            raise ValueError(f"operator {k} serves one baseline: a dense chunk, not counted")
        first.setdefault(_pow2(nv, 8), []).append(k)
    out = []
    for ops in first.values():
        buckets = {}
        for k in ops:
            buckets.setdefault((_pow2(op_nvecs[k]), _pow2(op_sizes[k])), []).append(k)
        for (vb, gb), members in buckets.items():
            if len(members) == 1 and op_sizes[members[0]] == gb:
                out.append(Chunk(1, gb, int(op_nvecs[members[0]]), gb))
            else:
                out.append(Chunk(len(members), gb, vb,
                                 int(sum(op_sizes[k] for k in members))))
    return out
