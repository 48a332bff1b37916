"""The system under test: calamity_tpu_torch, set up and fitted as its calibration does.

The only module of the benchmark that imports the port. Set-up hands the
port the benchmark's inputs as its own ``VisData`` and component dict,
packs them with ``FitSpec`` and warm-starts them as
``calibration.calibrate_and_model_tensor`` (serial) or
``calibration._calibrate_time_parallel`` (batched) does; a fit is then one
call of the entry the cell's traffic names:

- serial: ``solver.fit.fit_gains_and_foregrounds`` on one slice;
- batched: ``parallel.batched.batched_fit_core`` on every slice, once a
  phase of the mixed schedule, the float32 phase from the bfloat16 phase's
  result and optimizer state.

What a fit returns is a :class:`FitOut`: the fitted parameters on the
card, as the port lays them out, with the loss histories. :meth:`Fits.layout`
names the baseline each packed group holds, so that the benchmark can read
those parameters back in its own layout.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from calamity_tpu_torch import LAUNCHES, cal_utils
from calamity_tpu_torch.io.visdata import VisData
from calamity_tpu_torch.ops import lstsq
from calamity_tpu_torch.parallel import batched
from calamity_tpu_torch.solver import fit as fitmod
from calamity_tpu_torch.solver import graph
from calamity_tpu_torch.solver.tensorize import FitSpec

POL = "xx"
PACK_THREADS = 4  # host threads of the time-parallel calibration's packing

# what a configuration's "fit" and "basis" blocks may state, and the values
# of those the benchmark's comparison is written for: the mixed schedule
# (two phases, bfloat16 then float32 comps), float32 with TF32 off, the
# chi-square alone (no "sum" prior) and Adamax, which the reference runs
FIT_KEYS = {"optimizer", "learning_rate", "model_regularization", "remat", "comps_precision",
            "dtype", "tf32", "use_min"}
BASIS_KEYS = {"kind", "min_dly_ns", "offset_ns", "horizon", "eigenval_cutoff", "shared_basis",
              "nvec_bucketing"}
FIXED = {"optimizer": "Adamax", "comps_precision": "mixed", "dtype": "float32", "tf32": False,
         "kind": "dpss"}
REGULARIZATIONS = (None, "post_hoc")


class Settings(NamedTuple):
    """The port's fit arguments, each from the configuration's file."""

    optimizer: str
    learning_rate: float
    model_regularization: Any
    remat: bool
    use_min: bool
    shared_basis: bool
    nvec_bucketing: bool


def settings(fit, basis):
    """:class:`Settings` of a configuration's ``fit`` and ``basis`` blocks;
    refuses a key it does not know and a value the benchmark does not run."""
    unknown = sorted((set(fit) - FIT_KEYS) | (set(basis) - BASIS_KEYS))
    missing = sorted((FIT_KEYS - set(fit)) | (BASIS_KEYS - set(basis)))
    if unknown or missing:
        raise ValueError(f"configuration fit/basis keys: unknown {unknown}, missing {missing}")
    both = {**fit, **basis}
    for key, value in FIXED.items():
        if both[key] != value:
            raise ValueError(f"configuration {key} {both[key]!r}: the benchmark runs {value!r}")
    if fit["model_regularization"] not in REGULARIZATIONS:
        raise ValueError(f"configuration model_regularization {fit['model_regularization']!r}: "
                         f"the benchmark runs {REGULARIZATIONS}")
    return Settings(fit["optimizer"], float(fit["learning_rate"]), fit["model_regularization"],
                    bool(fit["remat"]), bool(fit["use_min"]), bool(basis["shared_basis"]),
                    bool(basis["nvec_bucketing"]))


class FitOut(NamedTuple):
    slices: list  # the slices this fit fitted, in row order
    g_r: Any  # (n, nants, nfreqs) on the card
    g_i: Any
    fg_r: Any  # per chunk (n, groups, nvecs) on the card
    fg_i: Any
    hist: Any  # per phase (steps, n) float64 numpy: the recorded losses
    final: Any  # (n,) the best recorded loss of the last phase
    steps: Any  # per phase (n,) recorded steps of each slice


def visdata(dep, data, flags, site, times):
    """The port's ``VisData`` of the deployment: ``data`` (ntimes x nbls,
    nfreqs) host visibilities, time-major; ``flags`` (nfreqs,) bool, the
    same at every time and baseline."""
    nt, nbls, nf = len(times), dep.nbls, dep.nfreqs
    flag = np.zeros((nt * nbls, 1, nf, 1), dtype=bool)
    flag[:, 0, flags, 0] = True
    return VisData(
        telescope_name="CALBENCH", instrument="CALBENCH",
        latitude=site["lat_deg"], longitude=site["lon_deg"], altitude=site["alt_m"],
        channel_width=float(dep.freqs[1] - dep.freqs[0]),
        ant_1_array=np.tile(dep.ant1, nt), ant_2_array=np.tile(dep.ant2, nt),
        antenna_numbers=np.arange(dep.nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(dep.nants)],
        antenna_positions=dep.ecef_rel, freq_array=dep.freqs[None, :],
        integration_time=np.full(nt * nbls, 10.7), lst_array=np.zeros(nt * nbls),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.repeat(np.asarray(times, dtype=np.float64), nbls),
        uvw_array=np.tile(dep.antpos[dep.ant2] - dep.antpos[dep.ant1], (nt, 1)),
        data_array=data.reshape(nt * nbls, 1, nf, 1),
        flag_array=flag,
        nsample_array=np.ones((nt * nbls, 1, nf, 1), dtype=np.float32),
    )


def comps_dict(dep, ops_host):
    """The component dict of the deployment: every baseline its own fitting
    group, keyed as the port keys them, its operator's (nfreqs, nvecs)
    float64 matrix (one object an operator, as an operator cache gives)."""
    op = dep.op_of_bl
    return {(((int(i), int(j)),),): ops_host[op[b]]
            for b, (i, j) in enumerate(zip(dep.ant1, dep.ant2))}


def _slice_rms(uvd, time):
    # the calibration's per-slice scale: rms of the unflagged data
    rows = np.isclose(uvd.time_array, time, rtol=0.0, atol=1e-7)
    unflagged = ~uvd.flag_array[rows, 0, :, 0]
    return float(np.sqrt(np.mean(np.abs(uvd.data_array[rows, 0, :, 0][unflagged]) ** 2)))


def launches():
    """The port's hand-written kernel launches so far, by name."""
    return LAUNCHES.counts()


def captures():
    """(number, seconds) of the CUDA-graph captures so far."""
    return len(graph.CAPTURES), sum(r["seconds"] for r in graph.CAPTURES)


class Fits:
    """The port, set up for one cell: ``mode`` "serial" or "batched", the
    traffic's ``steps`` a phase, its weights precision, the configuration's
    ``fit`` and ``basis`` blocks (:func:`settings`); :meth:`fit` runs the
    cell's next fit."""

    def __init__(self, uvd, comps, times, mode, steps, wgts_precision, device, fit, basis):
        self.mode, self.steps, self.device = mode, int(steps), torch.device(device)
        self.times = list(times)
        self.settings = settings(fit, basis)
        gains = cal_utils.blank_uvcal_from_uvdata(uvd)
        ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
        self.spec = FitSpec(uvd, comps, ants_map, device=self.device, dtype=np.float32,
                            nvec_bucketing=self.settings.nvec_bucketing,
                            shared_basis=self.settings.shared_basis)
        self.chunks = self.spec.device_chunks()
        rms = [_slice_rms(uvd, t) for t in self.times]
        g = [self.spec.pack_gains(gains, POL, t) for t in self.times]
        if mode == "serial":
            self._serial_setup(uvd, rms, g, wgts_precision)
        elif mode == "batched":
            self._batched_setup(uvd, rms, g, wgts_precision)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- #
    # serial: calibration.calibrate_and_model_tensor's per-slice set-up
    # ---------------------------------------------------------------- #
    def _serial_setup(self, uvd, rms, g, wgts_precision):
        self.packed = []
        for t, scale, (g_r, g_i) in zip(self.times, rms, g):
            dr, di, w = self.spec.pack_data(uvd, POL, t, data_scale_factor=scale,
                                            nsamples_in_weights=True)
            fr = tuple(self.spec.init_coeffs(dr, w))
            fi = tuple(self.spec.init_coeffs(di, w))
            if wgts_precision == "bfloat16":
                w = [x.to(torch.bfloat16) for x in w]
            self.packed.append((g_r, g_i, fr, fi, dr, di, w))

    def _serial_fit(self, k, steps):
        g_r, g_i, fr, fi, dr, di, w = self.packed[k]
        st = self.settings
        out = fitmod.fit_gains_and_foregrounds(
            g_r=g_r, g_i=g_i, fg_r=fr, fg_i=fi, data_r=dr, data_i=di, wgts=w,
            chunks=self.chunks, optimizer=st.optimizer, use_min=st.use_min, tol=0.0,
            maxsteps=steps, sky_model_r=dr, sky_model_i=di,
            model_regularization=st.model_regularization, remat=st.remat,
            comps_precision="mixed", patience=0, learning_rate=st.learning_rate)
        g_ro, g_io, fr_o, fi_o, history = out
        loss = np.asarray(history["loss"], dtype=np.float64)
        n1, n2 = history["phase_steps"]
        hist = [loss[:n1, None], loss[n1:n1 + n2, None]]
        final = np.array([np.min(hist[1]) if n2 else np.nan])
        return FitOut([k], g_ro[None], g_io[None], [x[None] for x in fr_o],
                      [x[None] for x in fi_o], hist, final,
                      [np.array([n1]), np.array([n2])])

    # ---------------------------------------------------------------- #
    # batched: calibration._calibrate_time_parallel's set-up
    # ---------------------------------------------------------------- #
    def _batched_setup(self, uvd, rms, g, wgts_precision):
        from concurrent.futures import ThreadPoolExecutor

        nb, nf, spec = len(self.times), self.spec.nfreqs, self.spec
        stacks = [[np.zeros((nb,) + m.conj.shape + (nf,), dtype=np.float32) for m in spec.meta]
                  for _ in range(3)]

        def extract(b):
            spec.pack_data_into(uvd, POL, self.times[b], *stacks, b, data_scale_factor=rms[b],
                                nsamples_in_weights=True)

        with ThreadPoolExecutor(max_workers=PACK_THREADS) as pool:
            list(pool.map(extract, range(nb)))
        dev = self.device

        def upload_wgts(w):
            if np.array_equal(w, np.broadcast_to(w[..., :1], w.shape)):
                # frequency-invariant weights: one plane, kept in float32
                return torch.as_tensor(np.ascontiguousarray(w[..., :1]), device=dev)
            w = torch.as_tensor(w, device=dev)
            return w.to(torch.bfloat16) if wgts_precision == "bfloat16" else w

        self.data_r = [torch.as_tensor(x, device=dev) for x in stacks[0]]
        self.data_i = [torch.as_tensor(x, device=dev) for x in stacks[1]]
        self.wgts = [upload_wgts(w) for w in stacks[2]]
        del stacks
        self.g_r = torch.stack([x[0] for x in g])
        self.g_i = torch.stack([x[1] for x in g])
        self.fg_r, self.fg_i = [], []
        zero = torch.zeros((nb,), dtype=torch.float32, device=dev)
        self.prior_r, self.prior_i = zero, zero.clone()
        for c, (comps, a0, _) in enumerate(self.chunks):
            chol, active = lstsq.gram_cholesky_chunk(comps)
            cr, ci, _, pr, pi = lstsq.blocked_init_from_data(
                chol, active, comps, self.data_r[c], self.data_i[c], self.wgts[c], a0.shape[0])
            self.fg_r.append(cr)
            self.fg_i.append(ci)
            self.prior_r, self.prior_i = self.prior_r + pr, self.prior_i + pi

    def _batched_fit(self, steps):
        st = self.settings
        cfg = fitmod.FitConfig(optimizer=st.optimizer,
                               opt_kwargs=(("learning_rate", st.learning_rate),),
                               maxsteps=steps, tol=0.0, use_min=st.use_min, remat=st.remat,
                               patience=0)
        lo = fitmod.convert_chunks_dtype(self.chunks, torch.bfloat16)
        args = (self.data_r, self.data_i, self.wgts)
        r1 = batched.batched_fit_core(cfg, lo, *args, self.g_r, self.g_i, self.fg_r, self.fg_i,
                                      self.prior_r, self.prior_i, poll_every=graph.POLL_EVERY)
        del lo
        r2 = batched.batched_fit_core(cfg, self.chunks, *args, r1.g_r, r1.g_i, r1.fg_r, r1.fg_i,
                                      self.prior_r, self.prior_i, opt_state0=r1.opt_state,
                                      poll_every=graph.POLL_EVERY)
        hist = [np.asarray(r.loss_history[:r.nsteps], dtype=np.float64) for r in (r1, r2)]
        return FitOut(list(range(len(self.times))), r2.g_r, r2.g_i, list(r2.fg_r),
                      list(r2.fg_i), hist, np.asarray(r2.final_loss.cpu(), dtype=np.float64),
                      [np.asarray(r.nsteps_slice) for r in (r1, r2)])

    # ---------------------------------------------------------------- #
    def slices_of(self, k):
        """The slices the ``k``-th fit fits."""
        return [k % len(self.times)] if self.mode == "serial" else list(range(len(self.times)))

    def fit(self, k=0, steps=None):
        """The cell's ``k``-th fit (serial: slice ``k`` mod the slices;
        batched: every slice), ``steps`` a phase (the traffic's by default)."""
        steps = self.steps if steps is None else int(steps)
        if self.mode == "serial":
            out = self._serial_fit(k % len(self.times), steps)
        else:
            out = self._batched_fit(steps)
        self._sync()
        return out

    def layout(self):
        """Per chunk, (antenna pairs (groups, 2) as antenna numbers, -1 on
        padding; valid (groups,) bool): the baseline each packed group
        holds."""
        return [(m.antpairs[:, 0, :], m.valid[:, 0]) for m in self.spec.meta]

    def close(self):
        """Drop every tensor the set-up made."""
        for name in ("spec", "chunks", "packed", "data_r", "data_i", "wgts", "g_r", "g_i",
                     "fg_r", "fg_i", "prior_r", "prior_i"):
            self.__dict__.pop(name, None)
