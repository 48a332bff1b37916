"""Mid-fit checkpoint and resume.

Port of calamity_tpu/solver/checkpoint.py in the form of its numpy
fallback (``:66-75``): a checkpoint is a directory holding ``state.npz``
(every leaf of the saved trees, plus named scalars and arrays) and
``treedef.pkl`` (the pickled structure of the trees). Leaves are tensors
(restored onto the device and dtype of the caller's template), Python
ints or 0-d integer tensors (the optimizer's step count, saved as an int
either way) or arrays. No orbax, no jax.

Saves are atomic: the state is written to a ``.tmp`` sibling and renamed
over the final name only when complete, so ``latest_checkpoint`` never
returns a half-written step. Unpickling runs only on files this module
wrote into a caller-chosen checkpoint directory.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, NamedTuple

import numpy as np
import torch


class FitCheckpoint(NamedTuple):
    """The carried state of a serial (one-slice) segmented descent."""

    params: Any
    opt_state: Any
    step: int
    prev_loss: float
    best_loss: float
    best_params: Any
    history: np.ndarray  # losses recorded so far (host array)


def _flatten(tree, leaves):
    """Structure of a tree of dicts, lists, tuples and NamedTuples; its
    leaves are appended to ``leaves`` in a fixed order."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("namedtuple", type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 and not (tree.dtype.is_floating_point or tree.dtype == torch.bool):
            # the optimizer's step count, on the device: saved as the int
            # it was before it moved there, so either form loads either
            return ("int",)
        return ("tensor", tuple(tree.shape))
    if isinstance(tree, (bool, int, float)):
        return (type(tree).__name__,)
    return ("array", tuple(np.shape(tree)))


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    if kind == "namedtuple":
        return spec[1](*(_unflatten(s, leaves) for s in spec[2]))
    if kind in ("list", "tuple"):
        items = [_unflatten(s, leaves) for s in spec[1]]
        return items if kind == "list" else tuple(items)
    return next(leaves)


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()  # npz has no bfloat16; the template restores it
        return leaf.numpy()
    return np.asarray(leaf)


def save_state(path, tree_state: dict, scalar_state: dict):
    """Persist a ``{name: tree}`` dict and a ``{name: scalar or array}``
    dict under the directory ``path``, atomically."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = []
    spec = _flatten(tree_state, leaves)
    np.savez(
        os.path.join(tmp, "state.npz"),
        **{f"leaf_{i}": _to_host(leaf) for i, leaf in enumerate(leaves)},
        **{k: np.asarray(v) for k, v in scalar_state.items()},
    )
    with open(os.path.join(tmp, "treedef.pkl"), "wb") as fh:
        pickle.dump(spec, fh)
    # the only non-atomic window (old removed, new still at .tmp) degrades
    # to resuming from the previous step: "step_N.tmp" is never a step
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_state(path, like_tree: dict, scalar_names):
    """Restore a :func:`save_state` checkpoint.

    ``like_tree`` gives the structure, and each tensor leaf the dtype and
    device to restore onto; a checkpoint of another structure or leaf shape
    raises ``ValueError``. ``scalar_names`` lists the scalar / array entries
    to return as numpy. Returns (tree_state, scalar_state)."""
    with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
        spec = pickle.load(fh)
    like_leaves = []
    like_spec = _flatten(like_tree, like_leaves)
    if spec != like_spec:
        raise ValueError(f"checkpoint {path} does not match the current fit structure")
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as data:
        stored = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
        scalar_state = {name: np.asarray(data[name]) for name in scalar_names}
    restored = []
    for arr, ref in zip(stored, like_leaves):
        if isinstance(ref, torch.Tensor):
            restored.append(torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype))
        elif isinstance(ref, (bool, int, float)):
            restored.append(type(ref)(arr))
        else:
            restored.append(arr)
    return _unflatten(spec, iter(restored)), scalar_state


def save_checkpoint(path, ckpt: FitCheckpoint):
    """Persist a FitCheckpoint (see save_state)."""
    save_state(
        path,
        {"params": ckpt.params, "opt_state": ckpt.opt_state, "best_params": ckpt.best_params},
        {
            "step": int(ckpt.step),
            "prev_loss": float(ckpt.prev_loss),
            "best_loss": float(ckpt.best_loss),
            "history": np.asarray(ckpt.history, dtype=np.float64),
        },
    )


def load_checkpoint(path, like: FitCheckpoint) -> FitCheckpoint:
    """Restore a FitCheckpoint saved by save_checkpoint; ``like`` gives the
    structure, dtypes and devices."""
    tree_state, scal = load_state(
        path,
        {"params": like.params, "opt_state": like.opt_state, "best_params": like.best_params},
        ("step", "prev_loss", "best_loss", "history"),
    )
    return FitCheckpoint(
        params=tree_state["params"],
        opt_state=tree_state["opt_state"],
        step=int(scal["step"]),
        prev_loss=float(scal["prev_loss"]),
        best_loss=float(scal["best_loss"]),
        best_params=tree_state["best_params"],
        history=np.asarray(scal["history"], dtype=np.float64),
    )


def _checkpoint_loadable(path):
    """Whether ``path`` holds a complete save that can be read."""
    try:
        with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
            pickle.load(fh)
        with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as data:
            data.files  # noqa: B018  (reads the archive's directory)
    except (OSError, EOFError, ValueError, pickle.UnpicklingError, AttributeError,
            ImportError):
        return False
    return True


def latest_checkpoint(directory):
    """Path of the highest-step loadable checkpoint (``step_N``) under
    ``directory``, or None. Step directories that cannot be read are
    skipped."""
    if directory is None or not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    for _, name in sorted(steps, reverse=True):
        path = os.path.join(directory, name)
        if _checkpoint_loadable(path):
            return path
    return None


def save_phase_meta(directory, **arrays):
    """Atomically persist phase-boundary diagnostics (the bfloat16 phase's
    loss history of a mixed-precision fit) as ``phase1_history.npz``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, "phase1_history.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(directory, "phase1_history.npz"))


def load_phase_meta(directory):
    """The dict persisted by save_phase_meta, or None when absent."""
    path = os.path.join(directory, "phase1_history.npz")
    if not os.path.isfile(path):
        return None
    with np.load(path) as meta:
        return {k: np.asarray(meta[k]) for k in meta.files}
