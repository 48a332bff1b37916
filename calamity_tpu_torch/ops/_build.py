"""Build and load the package's CUDA kernels.

The ``.cu`` sources under ``calamity_tpu_torch/csrc/`` expose plain C
launchers. On first use each is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library under
``calamity_tpu_torch/_build/``, keyed by a hash of the sources and flags,
and loaded with ``ctypes``. Nothing is built when the package is imported.
A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -split-compile=0: each nvcc runs its optimization passes on as many
# threads as the host has cores (the six instances of each chunk-loss
# kernel otherwise make one source the build's long pole)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """The loaded kernel library and how it was obtained."""

    def __init__(self, path, build_seconds, build_log):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an existing build was loaded
        self.build_log = build_log
        lib = ctypes.CDLL(path)
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fcl_error_string.argtypes = [ci]
        lib.fcl_error_string.restype = ctypes.c_char_p
        dd = ctypes.c_double
        # leaves, nleaves, carry, bias table, its length; 1 - b1, b1, b2, eps,
        # -lr; dtype; launched; stream
        lib.adamax_step.argtypes = [vp, ci, vp, vp, ll] + [dd] * 5 + [ci, vp, vp]
        lib.adamax_step.restype = ci
        # carry, dtype, stream
        lib.descent_carry.argtypes = [vp, ci, vp]
        lib.descent_carry.restype = ci
        lib.fcl_plan.argtypes = [ll] * 4 + [ci, ci, vp, ctypes.POINTER(ll)]
        lib.fcl_plan.restype = ci
        # comps, dtype; coeffs2, pr, pi, dr, di; d strides; w, dtype; w strides;
        # partials, dcoeffs, dpr, dpi, scratch; N, G, F, V; mode; stream
        lib.fused_chunk_loss.argtypes = (
            [vp, ci] + [vp] * 5 + [ll] * 3 + [vp, ci] + [ll] * 3 + [vp] * 5 + [ll] * 4 + [ci, vp]
        )
        lib.fused_chunk_loss.restype = ci
        # dpr2, dpi2, pieces, cot, dpr, dpi, dcoeffs; N, G, F, V; stream
        lib.fused_sum_combine.argtypes = [vp] * 7 + [ll] * 4 + [vp]
        lib.fused_sum_combine.restype = ci
        # dpr, dpi, scale, g_r, g_i, rowside, other, seg_start, seg_ant,
        # seg_slot, multi_ants, multi_slot, dg_r, dg_i, part_r, part_i; N, rows,
        # nants, F, nseg, nmulti, nslots, nentries; dtype; stream
        lib.gain_grad.argtypes = [vp] * 16 + [ll] * 8 + [ci, vp]
        lib.gain_grad.restype = ci
        # g_r, g_i, a0, a1, pr, pi; N, rows, nants, F; dtype; stream
        lib.gain_products.argtypes = [vp] * 6 + [ll] * 4 + [ci, vp]
        lib.gain_products.restype = ci
        # comps, dtype; coeffs2, pr, pi, dr, di; d strides; w, dtype; w strides;
        # valid, partials, dcoeffs, dpr, dpi, cot; N, G, F, V, U; mode; stream
        lib.shared_chunk_loss.argtypes = (
            [vp, ci] + [vp] * 5 + [ll] * 3 + [vp, ci] + [ll] * 3 + [vp] * 6 + [ll] * 5 + [ci, vp]
        )
        lib.shared_chunk_loss.restype = ci
        lib.shared_plan.argtypes = [ll] * 5 + [ci, ci, ctypes.POINTER(ll)]
        lib.shared_plan.restype = ci
        self.fcl_error_string = lib.fcl_error_string
        self.adamax_step = lib.adamax_step
        self.descent_carry = lib.descent_carry
        self.fused_chunk_loss = lib.fused_chunk_loss
        self.fused_sum_combine = lib.fused_sum_combine
        self.gain_grad = lib.gain_grad
        self.gain_products = lib.gain_products
        self.shared_chunk_loss = lib.shared_chunk_loss
        self._lib = lib

    def plan(self, nbatch, ngrps, nfreqs, nvecs, comps_dtype, mode, comps_ptr):
        """The kernel's launch plan as a dict (see ``fcl_plan`` in the
        source); raises on an empty or out-of-range shape."""
        out = (ctypes.c_longlong * 6)()
        err = self._lib.fcl_plan(nbatch, ngrps, nfreqs, nvecs, comps_dtype, mode, comps_ptr, out)
        if err != 0:
            raise ValueError(
                f"the fused chunk-loss kernel has no launch plan for N={nbatch}, G={ngrps}, "
                f"F={nfreqs}, V={nvecs} ({self.fcl_error_string(err).decode()})"
            )
        keys = ("slices_per_tile", "rows", "bulk", "pairs", "coef_smem", "smem_bytes")
        return dict(zip(keys, out))

    def shared_plan(self, nbatch, ngrps, nfreqs, nvecs, nu, comps_dtype, mode):
        """The shared-basis kernel's launch plan as a dict (see
        ``shared_plan`` in its source), the blocks an SM from the CUDA
        runtime's occupancy calculator; raises on a shape it does not
        take."""
        out = (ctypes.c_longlong * 8)()
        err = self._lib.shared_plan(nbatch, ngrps, nfreqs, nvecs, nu, comps_dtype, mode, out)
        if err != 0:
            raise ValueError(
                f"the shared-basis kernel has no launch plan for N={nbatch}, G={ngrps}, "
                f"F={nfreqs}, V={nvecs}, U={nu} ({self.fcl_error_string(err).decode()})"
            )
        keys = ("stages", "splits", "grid", "smem_bytes", "pre_split", "blocks_per_sm", "slices",
                "cluster")
        return dict(zip(keys, out))


_LOADED = []  # the library loaded in this process, once loaded


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default toolkit
    location. Raises if none is found."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels "
        "of calamity_tpu_torch are built from source on first use"
    )


def sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith((".cu", ".cuh"))
    )


def _digest(srcs):
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def _finish(started, every):
    """The log of one started nvcc; raises with it if nvcc failed, after
    stopping the others of ``every``."""
    cmd, proc = started
    out = proc.communicate()[0]
    if proc.returncode != 0:
        for _, other in every:
            other.kill()
            other.wait()
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
    return f"$ {' '.join(cmd)}\n{out}"


def load_kernels():
    """The kernel library, built from the sources if this version of them
    has not been built yet. Loaded once per process: later calls return the
    same library without looking at the sources again."""
    if _LOADED:
        return _LOADED[0]
    srcs = sources()
    key = _digest(srcs)
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libcalamity_kernels_{key}.so")
    log_path = so_path + ".log"
    build_seconds = 0.0
    if os.path.exists(so_path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                log = fh.read()
    else:
        nvcc = find_nvcc()
        # build into a temporary directory, then rename: a concurrent or
        # cut-off build never leaves a half-written library under the final name
        tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
        t0 = time.perf_counter()
        try:
            objs, procs = [], []
            for src in (s for s in srcs if s.endswith(".cu")):
                objs.append(os.path.join(tmp_dir, os.path.basename(src) + ".o"))
                procs.append(_start([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], src]))
            log = "".join(_finish(p, procs) for p in procs)
            tmp_path = os.path.join(tmp_dir, "lib.so")
            link = _start([nvcc, "-shared", "-o", tmp_path, *objs])
            log += _finish(link, [link])
            build_seconds = time.perf_counter() - t0
            with open(log_path, "w") as fh:
                fh.write(log)
            os.replace(tmp_path, so_path)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    lib = KernelLibrary(so_path, build_seconds, log)
    _LOADED.append(lib)
    return lib
