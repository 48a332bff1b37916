"""Packing between VisData/CalData containers and dense padded tensors.

Port of calamity_tpu/solver/tensorize.py:34-811. The numpy packing gives
the reference's arrays bit for bit; only the uploads differ: where the reference
calls ``jnp.asarray`` this module calls ``torch.as_tensor(..., device=...)``
on the device the ``FitSpec`` was built for. Layout:

    comps : (ngrps, nbls, nfreqs, nvecs)   basis vectors (nvecs zero-padded)
    a0/a1 : (ngrps, nbls) int32            antenna indices for gain gathers
    rows  : (ntimes, ngrps, nbls) int32    blt-row lookup for data extraction
    conj  : (ngrps, nbls) bool             data row conjugate of canonical ap

Each chunk's numpy comps stay on the host beside the device copy
(``FitSpec.host_comps``), so the write-back needs no device-to-host copy.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from .._device import SPANS, resolve_device
from ..ops.gains import antenna_csr, mark_valid
from ..io.polarizations import conj_pol_ind, polnum2str, polstr2num


def chunk_fitting_groups(fg_model_comps_dict, use_redundancy=False, grp_size_threshold=5,
                         nvec_bucketing=False):
    """Bucket fitting groups by per-group baseline count.

    Reference parity (calibration.py:30-101): when redundancy is not used,
    fitting groups whose redundant subgroups all have the same (small)
    size are split into per-position groups so they chunk together.

    ``nvec_bucketing`` additionally splits each baseline-count bucket by
    the next power of two of the group's mode count, bounding the zero
    padding of a chunk to less than 2x.

    Returns dict {(nbl, maxvecs): {fit_grp: comps matrix}}.
    """
    fg_model_comps_dict = dict(fg_model_comps_dict)
    if not use_redundancy:
        for fit_grp in list(fg_model_comps_dict.keys()):
            rlens = [len(red_grp) for red_grp in fit_grp]
            if len(rlens) < grp_size_threshold and min(rlens) == max(rlens):
                mat = fg_model_comps_dict.pop(fit_grp)
                for rednum in range(rlens[0]):
                    new_grp = tuple((red_grp[rednum],) for red_grp in fit_grp)
                    fg_model_comps_dict[new_grp] = mat

    def vec_bucket(nvec):
        if not nvec_bucketing:
            return 0
        b = 8
        while b < nvec:
            b *= 2
        return b

    buckets: Dict[tuple, List] = {}
    maxvecs: Dict[tuple, int] = {}
    for fit_grp, mat in fg_model_comps_dict.items():
        nbl = sum(len(red_grp) for red_grp in fit_grp)
        key = (nbl, vec_bucket(mat.shape[1]))
        buckets.setdefault(key, []).append(fit_grp)
        maxvecs[key] = max(maxvecs.get(key, 0), mat.shape[1])

    return {
        (key[0], maxvecs[key]): {grp: fg_model_comps_dict[grp] for grp in buckets[key]}
        for key in buckets
    }


class BltTable:
    """Vectorized (ant1, ant2) -> blt-row lookup over a baseline-time table.

    One lexsort of the whole table by (pair, time) resolves all pairs of a
    chunk in a handful of searchsorted/fancy-index calls."""

    def __init__(self, ant_1_array, ant_2_array, time_array):
        ant1 = np.asarray(ant_1_array, dtype=np.int64)
        ant2 = np.asarray(ant_2_array, dtype=np.int64)
        times = np.asarray(time_array, dtype=np.float64)
        self.M = int(max(ant1.max(initial=0), ant2.max(initial=0))) + 1
        keys = ant1 * self.M + ant2
        self.order = np.lexsort((times, keys))  # pair-major, time-minor
        skeys = keys[self.order]
        self.ukeys, self.starts, self.counts = np.unique(
            skeys, return_index=True, return_counts=True
        )
        self.times_sorted = times[self.order]

    def _find(self, keys):
        idx = np.searchsorted(self.ukeys, keys)
        idx_c = np.minimum(idx, len(self.ukeys) - 1)
        found = (len(self.ukeys) > 0) & (self.ukeys[idx_c] == keys)
        return np.where(found, idx_c, -1)

    def lookup_pairs(self, antpairs):
        """Resolve antenna pairs, preferring the forward orientation.

        antpairs: (..., 2) int array. Returns (sel, conj) where ``sel``
        indexes this table's unique-pair arrays and ``conj`` marks pairs
        found only in the reversed orientation. Raises KeyError naming the
        first missing pair."""
        aps = np.asarray(antpairs, dtype=np.int64)
        # antennas outside [0, M) cannot be in the table, and their a*M+b
        # keys would collide with in-range pairs' keys
        valid = np.all((aps >= 0) & (aps < self.M), axis=-1)
        kf = aps[..., 0] * self.M + aps[..., 1]
        kr = aps[..., 1] * self.M + aps[..., 0]
        i_f = np.where(valid, self._find(kf.ravel()).reshape(kf.shape), -1)
        i_r = np.where(valid, self._find(kr.ravel()).reshape(kr.shape), -1)
        conj = (i_f < 0) & (i_r >= 0)
        sel = np.where(conj, i_r, i_f)
        if np.any(sel < 0):
            bad = tuple(aps[np.unravel_index(int(np.argmin(sel)), sel.shape)])
            raise KeyError(f"antenna pair {bad} not present in data")
        return sel, conj

    def rows_matrix(self, sel, ntimes):
        """(ntimes, *sel.shape) blt rows per selected pair, time-sorted.

        Every selected pair must appear exactly ``ntimes`` times."""
        cnts = self.counts[sel]
        if not np.all(cnts == ntimes):
            bad = int(np.argmax(cnts != ntimes))
            raise ValueError(
                f"pair occurs {int(cnts.ravel()[bad])} times in the blt "
                f"table, expected {ntimes} (irregular baseline-time table)"
            )
        offs = np.arange(ntimes).reshape((ntimes,) + (1,) * sel.ndim)
        return self.order[self.starts[sel][None, ...] + offs]


class ChunkArrays(NamedTuple):
    """Device-resident static tensors for one chunk."""

    comps: Any  # (ngrps, nbls, nfreqs, nvecs)
    a0: Any  # (ngrps, nbls) int32
    a1: Any  # (ngrps, nbls) int32


class ChunkMeta(NamedTuple):
    """Host-side bookkeeping for extraction and write-back."""

    fit_grps: List  # fitting-group keys in packing order (None for padding)
    antpairs: np.ndarray  # (ngrps, nbls, 2) canonical antenna numbers
    rows: np.ndarray  # (ntimes, ngrps, nbls) int32 blt rows
    conj: np.ndarray  # (ngrps, nbls) bool
    valid: np.ndarray  # (ngrps, nbls) bool — False on padding entries


class FitSpec:
    """All static structure for fitting one dataset, on one device.

    ``device`` is required: the chunk tensors and every packed slice are
    uploaded there. Building it is the span ``pack.fitspec``, noted with
    the bytes of every chunk's basis on the device (``basis_bytes``), and
    each dense chunk's packing within it ``pack.dense``; packing a slice
    (:meth:`pack_data`, :meth:`pack_data_into`) the span ``pack.slice``; a
    warm start (:meth:`init_coeffs`) ``pack.warm_start``."""

    def __init__(self, visdata, fg_model_comps_dict, ants_map, device, dtype=np.float32,
                 use_redundancy=False, grp_size_threshold=5, nvec_bucketing=False,
                 shared_basis=False):
        with SPANS.span("pack.fitspec") as fitspec_span:
            self.device = resolve_device(device)
            self.dtype = np.dtype(dtype)
            self.ants_map = dict(ants_map)
            self.nants = len(ants_map)
            self.nfreqs = visdata.Nfreqs
            self.times = np.unique(visdata.time_array)
            self.ntimes = len(self.times)
            self.pols = visdata.get_pols()

            # red_grps for degenerate-renormalization bookkeeping
            self.red_grps = [rg for fit_grp in fg_model_comps_dict for rg in fit_grp]

            blt = BltTable(visdata.ant_1_array, visdata.ant_2_array, visdata.time_array)

            # ants_map as a dense lookup array for whole-chunk index mapping
            max_ant = max(self.ants_map) if self.ants_map else 0
            ant_index = np.full(max_ant + 1, -1, dtype=np.int64)
            for ant, idx in self.ants_map.items():
                ant_index[ant] = idx

            def map_ants(arr):
                out = ant_index[np.clip(arr, 0, max_ant)]
                invalid = (arr < 0) | (arr > max_ant) | (out < 0)
                if np.any(invalid):
                    raise KeyError(
                        f"antenna {int(arr[invalid].ravel()[0])} not in ants_map"
                    )
                return out.astype(np.int32)

            chunked = chunk_fitting_groups(
                fg_model_comps_dict,
                use_redundancy=use_redundancy,
                grp_size_threshold=grp_size_threshold,
                nvec_bucketing=nvec_bucketing,
            )

            self.chunks: List[ChunkArrays] = []
            self.meta: List[ChunkMeta] = []
            self.host_comps: List[np.ndarray] = []
            nfreqs = self.nfreqs

            def upload(comps, a0, a1, valid):
                self.host_comps.append(comps)
                chunk = ChunkArrays(*(self._upload(x) for x in (comps, a0, a1)))
                # the rows that hold a baseline, on the index tensor: the
                # gain-gradient kernel's lists leave the padding out
                mark_valid(chunk.a0, valid)
                if self.device.type == "cuda":
                    # the gain kernels' per-antenna row lists, once
                    antenna_csr(chunk.a0, chunk.a1, self.nants)
                self.chunks.append(chunk)

            def build_chunk(nbls, nvecs, grp_dict, shared_mat=None):
                """Pack one chunk. With shared_mat, every group uses the same
                basis matrix and comps is stored once with group dim 1.
                Returns the host comps."""
                ngrps = len(grp_dict)
                comps_ngrps = 1 if shared_mat is not None else ngrps
                comps = np.zeros((comps_ngrps, nbls, nfreqs, nvecs), dtype=self.dtype)
                fit_grps = list(grp_dict.keys())
                antpairs = np.fromiter(
                    (a for fg in fit_grps for rg in fg for ap in rg for a in ap),
                    dtype=np.int64,
                    count=ngrps * nbls * 2,
                ).reshape(ngrps, nbls, 2)
                a0 = map_ants(antpairs[..., 0])
                a1 = map_ants(antpairs[..., 1])
                sel, conj = blt.lookup_pairs(antpairs)
                rows = blt.rows_matrix(sel, self.ntimes).astype(np.int32)
                if shared_mat is not None:
                    comps[0, 0, :, : shared_mat.shape[1]] = shared_mat.astype(self.dtype)
                else:
                    for g, fit_grp in enumerate(fit_grps):
                        mat = np.asarray(grp_dict[fit_grp], dtype=self.dtype)
                        nred = len(fit_grp)
                        rep = np.repeat(
                            np.arange(nred), [len(rg) for rg in fit_grp]
                        )
                        comps[g, :, :, : mat.shape[1]] = mat.reshape(
                            nred, nfreqs, mat.shape[1]
                        )[rep]
                valid = np.ones((ngrps, nbls), bool)
                upload(comps, a0, a1, valid)
                self.meta.append(ChunkMeta(fit_grps, antpairs, rows, conj, valid))
                return comps

            def build_dense(nbls, nvecs, grp_dict):
                """Pack a chunk whose groups each have their own basis, as
                the span ``pack.dense`` noted with its groups, modes and
                the basis bytes uploaded."""
                with SPANS.span("pack.dense") as span:
                    comps = build_chunk(nbls, nvecs, grp_dict)
                    span.notes.update(groups=len(grp_dict), nvecs=nvecs, bytes=comps.nbytes)

            def build_shared_batched(classes, nvec_bucket, gmax):
                """Pack a bucket of operator classes into ONE shared-batched chunk.

                classes: list of (shared_mat, [fit_grp, ...]) with class sizes in
                (gmax//2, gmax]. Groups are laid out class-major and padded to
                gmax per class with zero-weight dummy entries, so the forward
                pass is a single batched matmul over the U operators."""
                nu = len(classes)
                ngrps = nu * gmax
                comps = np.zeros((nu, 1, nfreqs, nvec_bucket), dtype=self.dtype)
                a0 = np.zeros((ngrps, 1), dtype=np.int32)
                a1 = np.zeros((ngrps, 1), dtype=np.int32)
                rows = np.zeros((self.ntimes, ngrps, 1), dtype=np.int32)
                conj = np.zeros((ngrps, 1), dtype=bool)
                antpairs = np.full((ngrps, 1, 2), -1, dtype=np.int64)
                valid = np.zeros((ngrps, 1), dtype=bool)
                fit_grps = [None] * ngrps
                flat_g, flat_ap = [], []
                for u, (mat, grps) in enumerate(classes):
                    comps[u, 0, :, : mat.shape[1]] = mat.astype(self.dtype)
                    for k, fit_grp in enumerate(grps):
                        g = u * gmax + k
                        fit_grps[g] = fit_grp
                        flat_g.append(g)
                        flat_ap.append(fit_grp[0][0])
                flat_g = np.asarray(flat_g, dtype=np.int64)
                flat_ap = np.asarray(flat_ap, dtype=np.int64)  # (nvalid, 2)
                a0[flat_g, 0] = map_ants(flat_ap[:, 0])
                a1[flat_g, 0] = map_ants(flat_ap[:, 1])
                sel, cj = blt.lookup_pairs(flat_ap)
                rows[:, flat_g, 0] = blt.rows_matrix(sel, self.ntimes).astype(np.int32)
                conj[flat_g, 0] = cj
                antpairs[flat_g, 0] = flat_ap
                valid[flat_g, 0] = True
                upload(comps, a0, a1, valid)
                self.meta.append(ChunkMeta(fit_grps, antpairs, rows, conj, valid))

            for (nbls, nvecs), grp_dict in chunked.items():
                if shared_basis and nbls == 1:
                    # identity-first partition: the operator cache hands the SAME
                    # ndarray to every baseline of a given length, so id() catches
                    # virtually all sharing without hashing per group; one digest
                    # per distinct object merges equal-valued arrays from other
                    # sources (e.g. reloaded component dicts)
                    digests = {}

                    def _digest(mat):
                        key = id(mat)
                        if key not in digests:
                            # hold the array alongside its digest: id() keys are
                            # only stable while the object is alive
                            digests[key] = (
                                mat,
                                (mat.shape, hashlib.sha1(mat.tobytes()).hexdigest()),
                            )
                        return digests[key][1]

                    by_digest = {}
                    for fit_grp, mat in grp_dict.items():
                        mat = np.asarray(mat)
                        by_digest.setdefault(_digest(mat), []).append(fit_grp)
                    dense = {}
                    shared_classes = []
                    for key, grps in by_digest.items():
                        if len(grps) >= 2 and all(
                            len(fg) == 1 and len(fg[0]) == 1 for fg in grps
                        ):
                            shared_classes.append((np.asarray(grp_dict[grps[0]]), grps))
                        else:
                            for fg in grps:
                                dense[fg] = grp_dict[fg]

                    # bucket classes by (nvec pow2, class-size pow2): one batched
                    # chunk per bucket keeps the chunk count small when thousands
                    # of operators exist
                    def pow2(n):
                        b = 1
                        while b < n:
                            b *= 2
                        return b

                    buckets = {}
                    for mat, grps in shared_classes:
                        buckets.setdefault(
                            (pow2(mat.shape[1]), pow2(len(grps))), []
                        ).append((mat, grps))
                    for (vb, gb), classes in buckets.items():
                        if len(classes) == 1 and len(classes[0][1]) == gb:
                            # exactly one full class: plain shared chunk, no padding
                            mat, grps = classes[0]
                            build_chunk(
                                nbls, mat.shape[1],
                                {g: grp_dict[g] for g in grps}, shared_mat=mat,
                            )
                        else:
                            build_shared_batched(classes, vb, gb)
                    if dense:
                        build_dense(nbls, nvecs, dense)
                    continue
                build_dense(nbls, nvecs, grp_dict)
            fitspec_span.notes["basis_bytes"] = sum(
                c.comps.numel() * c.comps.element_size() for c in self.chunks)

    # ------------------------------------------------------------------ #
    # per-(time, pol) extraction
    # ------------------------------------------------------------------ #
    def _weights_rows(self, weights):
        """Per-chunk (ntimes, ngrps, nbls) row tables into a weights object.

        Built once per weights object and cached; the cache holds only the
        most recent weights object, which a fit reuses across all of its
        (time, pol) slices."""
        cached = getattr(self, "_wrows_cache", None)
        if cached is not None and cached[0] is weights:
            return cached[1]
        wtable = BltTable(
            weights.ant_1_array, weights.ant_2_array, weights.time_array
        )
        per_chunk = []
        offs = np.arange(self.ntimes)
        for meta in self.meta:
            ngrps, nbls = meta.conj.shape
            wrows = np.zeros((self.ntimes, ngrps, nbls), dtype=np.int64)
            vmask = meta.valid
            aps = meta.antpairs[vmask]  # (nvalid, 2)
            if len(aps) == 0:
                per_chunk.append(wrows)
                continue
            try:
                sel, _ = wtable.lookup_pairs(aps)
            except KeyError as e:
                raise KeyError(f"weights missing antpair: {e}") from None
            rows_v = np.zeros((self.ntimes, len(aps)), dtype=np.int64)
            cnts = wtable.counts[sel]
            starts = wtable.starts[sel]
            slow = np.ones(len(aps), dtype=bool)
            ok = cnts == self.ntimes
            if np.any(ok):
                blk = starts[ok][None, :] + offs[:, None]  # (ntimes, nok)
                tm = wtable.times_sorted[blk]
                aligned = np.all(
                    np.isclose(tm, self.times[:, None], rtol=0.0, atol=1e-7),
                    axis=0,
                )
                idx_ok = np.nonzero(ok)[0][aligned]
                rows_v[:, idx_ok] = wtable.order[blk[:, aligned]]
                slow[idx_ok] = False
            for j in np.nonzero(slow)[0]:
                # irregular time axis for this pair: per-time search
                blk_rows = wtable.order[starts[j] : starts[j] + cnts[j]]
                blk_times = wtable.times_sorted[starts[j] : starts[j] + cnts[j]]
                for ti, t in enumerate(self.times):
                    m = np.nonzero(
                        np.isclose(blk_times, t, rtol=0.0, atol=1e-7)
                    )[0]
                    if len(m) == 0:
                        raise KeyError(
                            f"weights missing antpair {tuple(aps[j])} at time {t}"
                        )
                    rows_v[ti, j] = blk_rows[m[0]]
            wrows[:, vmask] = rows_v
            per_chunk.append(wrows)
        self._wrows_cache = (weights, per_chunk)
        return per_chunk

    def time_index(self, time):
        idx = np.nonzero(np.isclose(self.times, time, rtol=0.0, atol=1e-7))[0]
        if len(idx) == 0:
            raise KeyError(f"time {time} not in dataset")
        return int(idx[0])

    def _upload(self, arr):
        return torch.as_tensor(arr, device=self.device)

    def pack_data(
        self,
        visdata,
        polarization,
        time,
        data_scale_factor=1.0,
        weights=None,
        nsamples_in_weights=False,
        as_numpy=False,
    ):
        """Extract chunked (data_r, data_i, wgts) for one (time, pol), as
        tensors on the spec's device.

        Semantics parity with reference tensorize_data (calibration.py:
        193-310): conjugation via row orientation, weights =
        UVFlag.weights x ~flags (x nsamples), normalized to unit total; the
        extraction is :meth:`pack_data_into`'s, into a one-slice stack.
        ``as_numpy=True`` returns the host numpy arrays without uploading."""
        with SPANS.span("pack.slice"):
            stacks = [[np.zeros((1,) + m.conj.shape + (self.nfreqs,), dtype=self.dtype)
                       for m in self.meta] for _ in range(3)]
            self.pack_data_into(visdata, polarization, time, *stacks, 0,
                                data_scale_factor=data_scale_factor, weights=weights,
                                nsamples_in_weights=nsamples_in_weights)
            data_r, data_i, wgts = ([x[0] for x in stack] for stack in stacks)
            if as_numpy:
                return data_r, data_i, wgts
            return tuple([self._upload(x) for x in xs] for xs in (data_r, data_i, wgts))

    def pack_data_into(
        self,
        visdata,
        polarization,
        time,
        out_r,
        out_i,
        out_w,
        slot,
        data_scale_factor=1.0,
        weights=None,
        nsamples_in_weights=False,
    ):
        """Write one (time, pol) slice directly into caller-preallocated
        per-chunk host stacks ``out_r/out_i/out_w[cnum]`` of shape
        ``(nbatch, ngrps_pad, nbls, nfreqs)``, at ``[slot]``
        (reference solver/tensorize.py:570-711), bit-equal to the
        reference's ``pack_data``, with no per-slice copies beyond the row
        gathers. Rows past a chunk's real group count
        and other slots are left untouched (callers preallocate zeros).
        ``out_w=None`` skips the weights (sky-model packs)."""
        with SPANS.span("pack.slice", join=True):  # pack_data's, where it calls this
            tind = self.time_index(time)
            polnum = polstr2num(polarization, x_orientation=visdata.x_orientation)
            pind = int(np.nonzero(visdata.polarization_array == polnum)[0][0])
            pind_c = conj_pol_ind(visdata.polarization_array, polnum)
            # a Python-float scale and a complex division keep the rounding
            # identical to pack_data
            scale = float(data_scale_factor)

            wpind = wpind_c = None
            wrows_chunks = None
            if weights is not None:
                wpolnum = polstr2num(polarization, x_orientation=weights.x_orientation)
                wmatch = np.nonzero(weights.polarization_array == wpolnum)[0]
                if len(wmatch) == 0:
                    avail = [
                        polnum2str(int(p), x_orientation=weights.x_orientation)
                        for p in weights.polarization_array
                    ]
                    raise ValueError(
                        f"weights object has no polarization {polarization!r} "
                        f"(available: {avail}); check the weights file passed "
                        "via weights/--weights_file"
                    )
                wpind = int(wmatch[0])
                wpind_c = conj_pol_ind(weights.polarization_array, wpolnum)
                wrows_chunks = self._weights_rows(weights)

            wgtsum = 0.0
            w_views = []
            for cnum, meta in enumerate(self.meta):
                rows = meta.rows[tind]  # (ngrps, nbls)
                ngrps = rows.shape[0]
                cj = meta.conj[..., None]
                mixed = not (pind_c == pind or not meta.conj.any())
                if mixed and pind_c < 0:
                    raise KeyError(
                        f"conjugate polarization of {polarization} not present "
                        "(needed to read conjugated cross-hand baselines)"
                    )

                def take(arr):
                    # conjugated rows of a cross-hand pol live in the conjugate
                    # pol column (xy stored as yx)
                    if not mixed:
                        return arr[rows, 0, :, pind]
                    return np.where(cj, arr[rows, 0, :, pind_c], arr[rows, 0, :, pind])

                vals = take(visdata.data_array)
                flg = take(visdata.flag_array)
                nsmp = take(visdata.nsample_array) if nsamples_in_weights else None
                vr = out_r[cnum][slot, :ngrps]
                vi = out_i[cnum][slot, :ngrps]
                vals = vals / scale  # complex divide, as pack_data does
                np.copyto(vr, vals.real, casting="unsafe")
                np.copyto(vi, vals.imag, casting="unsafe")
                # conjugated rows negate the imaginary part, in place
                np.negative(vi, out=vi, where=np.broadcast_to(cj, vi.shape))
                if out_w is None:
                    continue
                w = out_w[cnum][slot, :ngrps]
                if weights is None:
                    np.copyto(w, ~flg, casting="unsafe")
                else:
                    wrows = wrows_chunks[cnum][tind]
                    if wpind_c == wpind or not meta.conj.any():
                        np.copyto(w, weights.weights_array[wrows, 0, :, wpind], casting="unsafe")
                    else:
                        if wpind_c < 0:
                            raise KeyError(
                                f"conjugate polarization of {polarization} not "
                                "present in weights"
                            )
                        np.copyto(
                            w,
                            np.where(
                                cj,
                                weights.weights_array[wrows, 0, :, wpind_c],
                                weights.weights_array[wrows, 0, :, wpind],
                            ),
                            casting="unsafe",
                        )
                    w *= ~flg
                if nsamples_in_weights:
                    w *= nsmp
                w *= meta.valid[..., None]  # zero-weight padding entries
                # float32 pairwise sum, matching pack_data's normalization
                wgtsum += float(np.sum(w))
                w_views.append(w)
            for w in w_views:
                np.divide(w, wgtsum, out=w)

    def pack_gains(self, caldata, polarization, time):
        """(Nants, Nfreqs) real/imag gain tensors for one (time, pol)
        (reference tensorize_gains, calibration.py:369-399)."""
        polnum = polstr2num(polarization, x_orientation=caldata.x_orientation)
        pind = int(np.nonzero(caldata.jones_array == polnum)[0][0])
        tind = int(
            np.nonzero(np.isclose(caldata.time_array, time, rtol=0.0, atol=1e-7))[0][0]
        )
        # order gains by ants_map index
        garr = np.zeros((self.nants, self.nfreqs), dtype=np.complex128)
        for ant, idx in self.ants_map.items():
            aind = int(np.nonzero(caldata.ant_array == ant)[0][0])
            garr[idx] = caldata.gain_array[aind, 0, :, tind, pind]
        return (
            self._upload(garr.real.astype(self.dtype)),
            self._upload(garr.imag.astype(self.dtype)),
        )

    # ------------------------------------------------------------------ #
    # write-back
    # ------------------------------------------------------------------ #
    def insert_model(self, visdata_model, model_chunks, polarization, time, scale_factor=1.0):
        """Write per-chunk (vr, vi) foreground model arrays into a VisData.

        ``model_chunks`` are host arrays (fg_model_all_chunks_host). One
        fancy-indexed store per chunk."""
        tind = self.time_index(time)
        polnum = polstr2num(polarization, x_orientation=visdata_model.x_orientation)
        pind = int(np.nonzero(visdata_model.polarization_array == polnum)[0][0])
        pind_c = conj_pol_ind(visdata_model.polarization_array, polnum)
        # match the target VisData's precision: complex64 targets keep the
        # temporaries at half size
        real_dt = (
            np.float32
            if visdata_model.data_array.dtype == np.complex64
            else np.float64
        )
        for meta, (vr, vi) in zip(self.meta, model_chunks):
            vr = np.asarray(vr, dtype=real_dt)
            vi = np.asarray(vi, dtype=real_dt)
            vals = vr + 1j * vi
            vals *= scale_factor
            vals = np.where(meta.conj[..., None], np.conj(vals), vals)
            rows = meta.rows[tind].reshape(-1)
            keep = meta.valid.reshape(-1)  # padding entries must not write
            # conjugated rows of a cross-hand pol store the conjugate pol
            if pind_c != pind and meta.conj.any():
                if pind_c < 0:
                    raise KeyError(
                        f"conjugate polarization of {polarization} not present"
                    )
                cj = meta.conj.reshape(-1)
                pcol = np.where(cj, pind_c, pind)[keep]
                visdata_model.data_array[rows[keep], 0, :, pcol] = vals.reshape(
                    -1, self.nfreqs
                )[keep]
            else:
                visdata_model.data_array[rows[keep], 0, :, pind] = vals.reshape(
                    -1, self.nfreqs
                )[keep]

    def insert_gains(self, caldata, g_r, g_i, polarization, time):
        """Write fitted gains (tensors on any device) back into a CalData
        (reference insert_gains_into_uvcal, calibration.py:798-825)."""
        polnum = polstr2num(polarization, x_orientation=caldata.x_orientation)
        pind = int(np.nonzero(caldata.jones_array == polnum)[0][0])
        tind = int(
            np.nonzero(np.isclose(caldata.time_array, time, rtol=0.0, atol=1e-7))[0][0]
        )
        g = to_numpy(g_r).astype(np.float64) + 1j * to_numpy(g_i).astype(np.float64)
        for ant, idx in self.ants_map.items():
            aind = int(np.nonzero(caldata.ant_array == ant)[0][0])
            caldata.gain_array[aind, 0, :, tind, pind] = g[idx]

    def device_chunks(self):
        """Tuple of (comps, a0, a1) triples for the loss functions."""
        return tuple((c.comps, c.a0, c.a1) for c in self.chunks)

    def init_coeffs(self, data, wgts):
        """Least-squares warm-start coefficients per chunk.

        Uses gram Cholesky factors cached on first use: the gram depends
        only on the (static) basis matrices."""
        from ..ops.lstsq import gram_cholesky_chunk, init_coeffs_from_cholesky

        with SPANS.span("pack.warm_start"):
            if getattr(self, "_gram_chol", None) is None:
                self._gram_chol = [gram_cholesky_chunk(c.comps) for c in self.chunks]
            return [
                init_coeffs_from_cholesky(chol, active, c.comps, d, w)
                for (chol, active), c, d, w in zip(self._gram_chol, self.chunks, data, wgts)
            ]


def to_numpy(x):
    """Host numpy copy of a tensor (any device), or ``np.asarray`` of
    anything else."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
