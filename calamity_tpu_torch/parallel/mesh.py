"""The ('data', 'bl') device mesh over torch.distributed.

Port of calamity_tpu/parallel/mesh.py. The JAX package is one process over
a ``Mesh`` of devices, and XLA inserts the collectives. Here each device has
a process of its own (launched by ``torchrun``, or by the caller), the
default process group joins them, and the collectives are explicit. The
placement rules are the JAX package's:

    gains     (nbatch, nants, nfreqs)        -> ('data', None, None)   [replicated over 'bl']
    coeffs    (nbatch, ngrps, nvecs)         -> ('data', 'bl', None)
    comps     (ngrps, nbls, nfreqs, nvecs)   -> ('bl', None, None, None)
    data/wgts (nbatch, ngrps, nbls, nfreqs)  -> ('data', 'bl', None, None)

A spec names, for each axis, the mesh dimension it is split over (None:
whole on every rank); each rank holds the block at its coordinates
(:func:`local_block`). A plain shared operator (comps group dim 1) is
replicated. The per-slice losses and the gain gradients are summed over
'bl'; coefficient gradients stay on their rank (:class:`MeshShard`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gains import carry_valid

AXES = ("data", "bl")


def make_mesh(n_data=None, n_bl=None, device_type=None):
    """A ('data', 'bl') ``DeviceMesh`` over the ranks of the initialized
    default process group.

    The default factorization puts every rank on 'bl' (the large axis of a
    HERA-scale fit) and the rest on 'data'. ``device_type`` is the mesh's
    (default: "cuda" under NCCL, "cpu" under gloo); it does not move any
    tensor."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group, or launch under torchrun"
        )
    n = dist.get_world_size()
    if n_data is None and n_bl is None:
        n_bl = n
        n_data = 1
    elif n_data is None:
        n_data = n // n_bl
    elif n_bl is None:
        n_bl = n // n_data
    if n_data * n_bl != n:
        raise ValueError(f"mesh {n_data}x{n_bl} != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_bl), mesh_dim_names=AXES)


def mesh_shape(mesh):
    """``{"data": n_data, "bl": n_bl}`` of a mesh from :func:`make_mesh`."""
    if getattr(mesh, "mesh_dim_names", None) != AXES:
        raise TypeError(
            f"mesh must be a ('data', 'bl') DeviceMesh from make_mesh, got {mesh!r}"
        )
    return {name: mesh.size(i) for i, name in enumerate(AXES)}


def fit_shardings(mesh):
    """The placement specs of the batched fit state (see module docstring),
    for :func:`local_block`."""
    mesh_shape(mesh)
    return {
        "gains": ("data", None, None),
        "coeffs": ("data", "bl", None),
        "comps": ("bl", None, None, None),
        "ants": ("bl", None),
        "data": ("data", "bl", None, None),
        "scalar": (),
    }


def local_block(mesh, x, spec):
    """This rank's block of ``x`` (a tensor or array) under ``spec``; an
    axis split over a mesh dimension must be a multiple of its size."""
    shape = mesh_shape(mesh)
    coords = dict(zip(AXES, mesh.get_coordinate()))
    index = tuple(slice(None) if name is None
                  else _block_slice(coords[name], shape[name], x.shape[axis], name)
                  for axis, name in enumerate(spec))
    return x[index]


def _block_slice(coord, n, size, name):
    # the ``coord``-th of ``n`` equal blocks of a ``size``-long axis
    if size % n:
        raise ValueError(f"an axis of {size} is not a multiple of mesh '{name}' ({n})")
    step = size // n
    return slice(coord * step, (coord + 1) * step)


def shard_chunk(mesh, chunk, data_r, data_i, wgts, device=None):
    """This rank's block of one chunk's tensors and of its batched data,
    on ``device`` (default: where they are).

    A plain shared operator matrix (comps group dim 1) is replicated, not
    split over 'bl'. Group and batch axes that are not multiples of the
    mesh raise: the driver (``calibrate_and_model_tensor(time_parallel=True,
    mesh=...)``) pads both first; use it, or pad the same way."""
    shape = mesh_shape(mesh)
    n_bl, n_data = shape["bl"], shape["data"]
    comps, a0 = chunk[0], chunk[1]
    ngrps = a0.shape[0]
    if ngrps % n_bl or data_r.shape[0] % n_data:
        raise ValueError(
            f"chunk group axis ({ngrps}) and batch axis ({data_r.shape[0]}) "
            f"must be multiples of the mesh ({n_data}x{n_bl}); pad with "
            "zero-weight entries as _calibrate_time_parallel does, or call "
            "the driver with time_parallel=True, mesh=..."
        )
    if comps.shape[0] != 1 and comps.shape[0] % n_bl:
        raise ValueError(
            f"comps leading axis ({comps.shape[0]}) must be 1 (shared) or a "
            f"multiple of n_bl={n_bl} (dense / shared-batched class axis)"
        )
    shard = MeshShard(mesh, "cpu" if device is None else device, nbatch=data_r.shape[0])
    where = device if device is not None else getattr(a0, "device", "cpu")
    data = (torch.as_tensor(contiguous(shard.block(x)), device=device)
            for x in (data_r, data_i, wgts))
    return (shard.chunk(chunk, where), *data)


def contiguous(x):
    """A C-ordered copy of a strided block (numpy array or tensor)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return np.ascontiguousarray(x)


def init_distributed_from_env(device):
    """Join the default process group that ``torchrun`` describes
    (``WORLD_SIZE`` > 1, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), where one is described and none is initialized yet.

    The backend follows the device: NCCL for CUDA, gloo for the CPU. A
    "cuda" device without an index becomes ``cuda:LOCAL_RANK``. Returns
    (device, whether this call created the group, for the caller to
    destroy)."""
    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device, False
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device, True


def is_writer():
    """Whether this process writes the run's files: rank 0 of an
    initialized process group, or a process without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MeshShard:
    """This rank's place on the mesh for one sharded fit, and the
    collectives of its descent.

    ``nbatch``: the fit's real slice count; the batch is split over 'data'
    after padding to an ``n_data`` multiple (dummy rows freeze from the
    start). ``nbatch=None`` leaves 'data' unused: every rank holds every
    row (the warm-started scan, whose times run in order). ``device``
    carries the collectives' tensors (CUDA under NCCL; gloo takes either).
    ``collective_s`` and ``collective_calls`` count this rank's host
    seconds in collective calls and their number."""

    def __init__(self, mesh, device, nbatch=None):
        shape = mesh_shape(mesh)
        coords = dict(zip(AXES, mesh.get_coordinate()))
        self.mesh = mesh
        self.device = torch.device(device)
        self.n_bl = shape["bl"]
        self.bl_index = coords["bl"]
        self.bl_group = mesh.get_group("bl")
        self.data_group = mesh.get_group("data")
        self.shards_rows = nbatch is not None
        self.n_data = shape["data"] if self.shards_rows else 1
        self.data_index = coords["data"] if self.shards_rows else 0
        self.nbatch = None if nbatch is None else -(-int(nbatch) // self.n_data) * self.n_data
        self.nreal = nbatch
        self.collective_s = 0.0
        self.collective_calls = 0

    def _all_reduce(self, t, group):
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        self.collective_s += time.perf_counter() - t0
        self.collective_calls += 1

    # ---------------------------------------------------------------- #
    # placement
    # ---------------------------------------------------------------- #
    def rows(self, n=None):
        """Slice of this rank's rows of an ``n``-row batch (default the
        padded batch; every row where 'data' is unused)."""
        if not self.shards_rows:
            return slice(None)
        return _block_slice(self.data_index, self.n_data,
                            self.nbatch if n is None else n, "data")

    def groups(self, ngrps):
        """Slice of this rank's groups of an ``ngrps``-group chunk axis."""
        return _block_slice(self.bl_index, self.n_bl, ngrps, "bl")

    def block(self, x, axis=1):
        """This rank's block of a stack (tensor or array) whose ``axis`` is
        a padded group axis and, for ``axis`` > 0, axis 0 the batch."""
        index = [slice(None)] * (axis + 1)
        if axis:
            index[0] = self.rows(x.shape[0])
        index[axis] = self.groups(x.shape[axis])
        return x[tuple(index)]

    def chunk(self, chunk, device=None):
        """This rank's block of a padded chunk's ``(comps, a0, a1)``,
        C-ordered, on ``device`` (default: where they are): a plain shared
        operator (comps group dim 1) is whole on every rank."""
        comps, a0, a1 = chunk
        if comps.shape[0] != 1:
            comps = self.block(comps, axis=0)
        out = tuple(contiguous(x) for x in (comps, self.block(a0, axis=0),
                                            self.block(a1, axis=0)))
        if device is not None:
            out = tuple(torch.as_tensor(x, device=device) for x in out)
        carry_valid(a0, out[1], self.groups(a0.shape[0]))  # the block's rows that hold a baseline
        return out

    def valid_rows(self):
        """(local rows,) bool: False on the dummy rows of the padded batch."""
        if not self.shards_rows:
            return None
        idx = np.arange(self.nbatch)[self.rows()]
        return torch.as_tensor(idx < self.nreal, device=self.device)

    # ---------------------------------------------------------------- #
    # reductions
    # ---------------------------------------------------------------- #
    def _reduce(self, t, group, n):
        # a value, never a node of the autograd graph
        if n == 1:
            return t.detach()
        out = t.detach().clone()
        self._all_reduce(out, group)
        return out

    def sum_bl(self, t):
        """Sum over the 'bl' ranks (a group's partial over its groups)."""
        return self._reduce(t, self.bl_group, self.n_bl)

    def sum_data(self, t):
        return self._reduce(t, self.data_group, self.n_data)

    def sum_world(self, t):
        return self.sum_data(self.sum_bl(t))

    def sum_bl_host(self, arr):
        """:meth:`sum_bl` of a host float64 array."""
        t = torch.as_tensor(np.asarray(arr, dtype=np.float64), device=self.device)
        return self.sum_bl(t).cpu().numpy()

    def any_rows(self, flag):
        """Whether ``flag`` (a 0-d bool tensor) holds on any 'data' rank:
        ranks of one 'bl' group share their rows."""
        if self.n_data == 1:
            return flag
        return self.sum_data(flag.to(torch.int32)) > 0

    def all_frozen(self, frozen):
        """Whether every slice of the batch is frozen (a host bool)."""
        local = frozen.all()
        if self.n_data > 1:
            local = self.sum_data((~local).to(torch.int32)) == 0
        return bool(local)

    def lamb_norm_psum(self, sq):
        """LAMB's squared leaf norms summed over the axes each leaf is
        split on: gains over 'data' (replicated over 'bl', counted once),
        coefficients over 'data' and 'bl'."""
        out = dict(sq)
        for k in ("g_r", "g_i"):
            out[k] = self.sum_data(sq[k])
        for k in ("fg_r", "fg_i"):
            if k in sq:
                out[k] = [self.sum_world(x) for x in sq[k]]
        return out

    # ---------------------------------------------------------------- #
    # gathers: every rank gets the whole array (an all-reduce into zeros,
    # which gloo does for CUDA tensors where it has no all_gather)
    # ---------------------------------------------------------------- #
    def _gather(self, t, full_shape, index, writes):
        out = torch.zeros(full_shape, dtype=_wire(t.dtype), device=self.device)
        if writes:
            out[index] = t.to(device=self.device, dtype=out.dtype)
        if self.n_bl * self.n_data > 1:
            self._all_reduce(out, None if self.shards_rows else self.bl_group)
        return out.to(t.dtype)

    def gather_rows(self, t):
        """A ('data', ...) tensor replicated over 'bl', whole on every rank."""
        if not self.shards_rows or self.n_data == 1:
            return t
        full = (t.shape[0] * self.n_data,) + tuple(t.shape[1:])
        return self._gather(t, full, (self.rows(full[0]),), self.bl_index == 0)

    def gather_rows_host(self, arr, axis=0):
        """:meth:`gather_rows` of a host array along ``axis``."""
        if not self.shards_rows or self.n_data == 1:
            return arr
        t = torch.as_tensor(np.moveaxis(np.asarray(arr), axis, 0), device=self.device)
        return np.moveaxis(self.gather_rows(t).cpu().numpy(), 0, axis)

    def gather_coeffs(self, t):
        """A ('data', 'bl', ...) tensor, whole on every rank."""
        if self.n_bl * self.n_data == 1:
            return t
        nb = t.shape[0] * self.n_data
        ng = t.shape[1] * self.n_bl
        full = (nb, ng) + tuple(t.shape[2:])
        return self._gather(t, full, (self.rows(nb), self.groups(ng)), True)

    def local_rows(self, t):
        return t[self.rows(t.shape[0])]

    def local_coeffs(self, t):
        return t[self.rows(t.shape[0]), self.groups(t.shape[1])]

    def gather_params(self, tree):
        """A parameter-shaped tree (``{"g_r", "g_i"[, "fg_r", "fg_i"]}``, or
        an optimizer state whose fields are such trees), whole."""
        return _map_params(tree, self.gather_rows, self.gather_coeffs)

    def local_params(self, tree):
        """The inverse of :meth:`gather_params`: this rank's blocks."""
        return _map_params(tree, self.local_rows, self.local_coeffs)

    def barrier(self):
        """Every rank waits here: after rank 0's saves, so that no rank
        reads a half-written step."""
        if dist.get_world_size() > 1:
            dist.barrier()


def _wire(dtype):
    # bool travels as uint8; every other dtype as it is
    return torch.uint8 if dtype == torch.bool else dtype


def _map_params(tree, rows_fn, coeffs_fn):
    if isinstance(tree, dict) and "g_r" in tree:
        out = {k: rows_fn(tree[k]) for k in ("g_r", "g_i")}
        for k in ("fg_r", "fg_i"):
            if k in tree:
                out[k] = [coeffs_fn(x) for x in tree[k]]
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_params(x, rows_fn, coeffs_fn) for x in tree))
    return tree
