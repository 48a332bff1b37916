"""Worlds of CPU processes for the port's mesh tests.

``run_world(fn, nprocs, tmp_path, *args)`` starts ``nprocs`` spawned
processes joined by a gloo process group (``init_method="file://..."``
under ``tmp_path``), calls ``fn(rank, nprocs, *args)`` in each and returns
their results in rank order. The world runs under its own time limit: on
expiry, or when a rank fails, every process still alive is killed and the
test fails, so a deadlocked collective cannot hang the test run.

The scenario functions below run in those processes; they import the port
only (each process is a fresh interpreter).
"""

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
import uuid

WORLD_TIMEOUT_S = 240.0


def _child(fn, rank, nprocs, init_file, args, results, env):
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if init_file is not None:
            dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                    world_size=nprocs)
        out = fn(rank, nprocs, *args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, nprocs, tmp_path, *args, timeout=WORLD_TIMEOUT_S, torchrun_env=False):
    """``fn(rank, nprocs, *args)`` on every rank of a gloo world; returns the
    ranks' results. With ``torchrun_env`` the processes get the variables
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` on localhost) and no group: ``fn``
    joins it itself."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = None if torchrun_env else os.path.join(str(tmp_path), f"rdzv_{uuid.uuid4().hex}")
    port = _free_port() if torchrun_env else None
    procs = []
    for rank in range(nprocs):
        env = {}
        if torchrun_env:
            env = {"WORLD_SIZE": str(nprocs), "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(ctx.Process(target=_child, args=(fn, rank, nprocs, init_file, args,
                                                      results, env)))
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < nprocs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise AssertionError(f"world of {nprocs} did not finish in {timeout:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(remaining, 2.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and len(out) < nprocs:
                    # a rank died without reporting (killed): give the
                    # queue one more read, then fail
                    try:
                        rank, status, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise AssertionError(f"a rank exited with {dead}") from None
                else:
                    continue
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    return [out[r] for r in range(nprocs)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------- #
# scenarios
# ---------------------------------------------------------------------- #
def fit_outputs(out):
    """The arrays and histories of a driver's (model, resid, gains,
    fit_history)."""
    model, resid, gains, hist = out
    return {"model": model.data_array, "resid": resid.data_array, "gains": gains.gain_array,
            "model_flags": model.flag_array, "resid_flags": resid.flag_array,
            "gain_flags": gains.flag_array, "hist": hist}


def time_parallel_cases(rank, nprocs, mesh_shape, cases):
    """Each case (``name``, VisData, kwargs) through
    ``calibrate_and_model_dpss(time_parallel=True, mesh=make_mesh(*mesh_shape))``
    on the CPU; returns {name: fit_outputs}, plus the timings' collective
    counts under "timings"."""
    from calamity_tpu_torch import calibration as tcal
    from calamity_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*mesh_shape)
    res = {}
    for name, uvd, kw in cases:
        timings = {}
        out = tcal.calibrate_and_model_dpss(uvdata=uvd, device="cpu", time_parallel=True,
                                            mesh=mesh, timings=timings, **kw)
        res[name] = fit_outputs(out)
        res[name]["timings"] = {k: v for k, v in timings.items()
                                if k in ("collective_calls", "phase_steps")}
    return res


def cut_and_resume(rank, nprocs, mesh_shape, uvd, kw, ckdir, cut_at):
    """A checkpointed sharded run stopped on every rank right after the
    ``cut_at``-th save (the barrier that follows a save of rank 0), resumed
    into the same directory, and an uninterrupted run into another: returns
    (the resumed run's fit_outputs, the uninterrupted run's, the saves the
    cut run made)."""
    from calamity_tpu_torch import calibration as tcal
    from calamity_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(*mesh_shape)
    real_barrier = tmesh.MeshShard.barrier
    calls = []

    def stopping_barrier(self):
        real_barrier(self)
        calls.append(1)
        if len(calls) == cut_at:
            raise RuntimeError("injected stop")

    def run(tag):
        return tcal.calibrate_and_model_dpss(uvdata=uvd.copy(), device="cpu",
                                             time_parallel=True, mesh=mesh,
                                             checkpoint_dir=os.path.join(ckdir, tag), **kw)

    tmesh.MeshShard.barrier = stopping_barrier
    try:
        run("cut")
    except RuntimeError as exc:
        if "injected stop" not in str(exc):
            raise
    finally:
        tmesh.MeshShard.barrier = real_barrier
    return fit_outputs(run("cut")), fit_outputs(run("straight")), len(calls)


def cli_main(rank, nprocs, argv):
    """The port's CLI in a process that ``torchrun`` would have started."""
    from calamity_tpu_torch import cli

    cli.main(argv)
    return True


def cli_counting_saves(rank, nprocs, argv):
    """:func:`cli_main`, returning the paths of the checkpoint saves this
    process made (``save_state`` and ``save_phase_meta``)."""
    from calamity_tpu_torch import cli
    from calamity_tpu_torch.solver import checkpoint

    saves = []

    def counted(real):
        def save(path, *args, **kwargs):
            saves.append(os.path.normpath(path))
            return real(path, *args, **kwargs)
        return save

    for name in ("save_state", "save_phase_meta"):
        setattr(checkpoint, name, counted(getattr(checkpoint, name)))
    cli.main(argv)
    return saves


def mesh_checks(rank, nprocs):
    """make_mesh's shapes and errors on this world (tests/test_parallel.py:23-30)."""
    from calamity_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    out = {"default": mesh_shape(make_mesh()),
           "data2": mesh_shape(make_mesh(n_data=2)),
           "bl2": mesh_shape(make_mesh(n_bl=2)),
           "names": make_mesh(1, nprocs).mesh_dim_names}
    try:
        make_mesh(n_data=3, n_bl=5)
    except ValueError as exc:
        out["error"] = str(exc)
    return out


def zero_plateau(rank, nprocs, mesh_shape, arrays, cfg):
    """The zero-plateau patience fit of tests/conftest.py, two slices,
    through ``batched_fit_core`` on this rank's blocks (``shard_chunk``);
    returns the whole result's per-slice steps, history and final losses."""
    import torch

    from calamity_tpu_torch.parallel.batched import batched_fit_core
    from calamity_tpu_torch.parallel.mesh import (
        MeshShard,
        fit_shardings,
        local_block,
        make_mesh,
        shard_chunk,
    )

    comps, a0, a1, data_r, data_i, wgts, g_r, g_i, fg = (torch.as_tensor(x) for x in arrays)
    mesh = make_mesh(*mesh_shape)
    sh = fit_shardings(mesh)
    chunk, dr, di, w = shard_chunk(mesh, (comps, a0, a1), data_r, data_i, wgts)
    shard = MeshShard(mesh, "cpu", nbatch=data_r.shape[0])
    res = batched_fit_core(cfg, (chunk,), (dr,), (di,), (w,), local_block(mesh, g_r, sh["gains"]),
                           local_block(mesh, g_i, sh["gains"]),
                           (local_block(mesh, fg, sh["coeffs"]),),
                           (torch.zeros_like(local_block(mesh, fg, sh["coeffs"])),),
                           torch.zeros((1,)), torch.zeros((1,)), shard=shard)
    return {"nsteps_slice": res.nsteps_slice.tolist(), "history": res.loss_history,
            "final": res.final_loss.numpy()}
