"""The gain products and their gradient (``calamity_tpu_torch.ops.gains``)
against the old torch ops and the JAX package.

``GainProducts``' backward on the CPU is the plain version, the
``index_select`` backward under autograd; it is held against the JAX
package's ``jax.vjp`` through ``calamity_tpu.ops.loss.gain_products`` in
float64 (rel 1e-12: only the order of a few dozen additions differs), for
the dense, dense multi-baseline, shared and shared-batched chunk layouts,
a slice axis, a padded row and an antenna with no rows. The CUDA kernel
sums each antenna's entries in the order of its CSR list: the list is
checked, and a numpy loop in that order is held against the plain version
(rel 1e-12); the products kernel equals the torch ops to the bit
(``gpu``). The lists leave out the rows that hold no baseline (a
shared-batched chunk's padding, ``ChunkMeta.valid``): checked for a packed
chunk of the HERA core at cut size, for each group-block view of it and for
each rank's block of a 2-rank mesh; a slice that lost the record raises;
every index tensor that a descent hands the gain products (serial,
time-parallel in group blocks, the scan) carries it. The segment table covers every entry
once, in order; a torch walk of the segmented lists in the kernel's two
passes is held against the plain version (rel 1e-6, float64), with padding
and with a skewed antenna. ``GainProducts`` on the CPU is held against the
JAX package's ``gain_products`` and its ``jax.vjp`` in float32 (rel 1e-6
forward, 1e-5 gradient) as well. The kernels themselves run on the card
only (``gpu`` tests; they have no CPU mode).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.ops import loss as jloss
from calamity_tpu_torch import cal_utils, calibration
from calamity_tpu_torch.ops import gains
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.parallel import mesh
from calamity_tpu_torch.solver.tensorize import FitSpec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import hera_core_demo_torch as demo  # noqa: E402

NA, NF = 7, 16  # antenna 6 is in no row


def _indices(rng, kind):
    """(a0, a1) of one chunk in the given layout: (ngrps, nbls) int32."""
    ngrps, nbls = {"dense": (5, 1), "dense_b2": (3, 2), "shared": (4, 1),
                   "shared_batched": (6, 1), "padded": (5, 1)}[kind]
    a0 = rng.integers(0, NA - 1, (ngrps, nbls)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, NA - 2, (ngrps, nbls))) % (NA - 1)).astype(np.int32)
    if kind == "padded":  # a padding row: antenna 0 with itself, zero cotangent
        a0[-1], a1[-1] = 0, 0
    return a0, a1


def _problem(kind, nbatch, seed=3):
    rng = np.random.default_rng(seed)
    a0, a1 = _indices(rng, kind)
    g_r = 1 + 0.1 * rng.standard_normal((nbatch, NA, NF))
    g_i = 0.1 * rng.standard_normal((nbatch, NA, NF))
    dpr = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    dpi = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    if kind == "padded":
        dpr[:, -1] = dpi[:, -1] = 0.0
    return a0, a1, g_r, g_i, dpr, dpi


def _jax_grads(a0, a1, g_r, g_i, dpr, dpi):
    out = []
    for n in range(g_r.shape[0]):
        _, vjp = jax.vjp(lambda gr, gi: jloss.gain_products(gr, gi, jnp.asarray(a0),
                                                            jnp.asarray(a1)),
                         jnp.asarray(g_r[n]), jnp.asarray(g_i[n]))
        out.append(vjp((jnp.asarray(dpr[n]), jnp.asarray(dpi[n]))))
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", ["dense", "dense_b2", "shared", "shared_batched", "padded"])
def test_gain_products_backward_matches_old_autograd_and_jax(kind, nbatch):
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, nbatch)
    t = [torch.as_tensor(x) for x in (g_r, g_i, dpr, dpi)]
    gr, gi = (x.clone().requires_grad_(True) for x in t[:2])
    ia0, ia1 = torch.as_tensor(a0), torch.as_tensor(a1)
    pr, pi = gains.gain_products_batched(gr, gi, ia0, ia1)
    got = torch.autograd.grad((pr, pi), (gr, gi), (t[2], t[3]))
    # the old ops: index_select under autograd
    gr2, gi2 = (x.clone().requires_grad_(True) for x in t[:2])
    shape = (nbatch,) + a0.shape + (NF,)
    old = [g.index_select(1, i.reshape(-1)).reshape(shape) for g, i in
           ((gr2, ia0), (gr2, ia1), (gi2, ia0), (gi2, ia1))]
    old_pr, old_pi = old[0] * old[1] + old[2] * old[3], old[0] * old[3] - old[2] * old[1]
    want_old = torch.autograd.grad((old_pr, old_pi), (gr2, gi2), (t[2], t[3]))
    want_jax = _jax_grads(a0, a1, g_r, g_i, dpr, dpi)
    for g, w_old, w_jax in zip(got, want_old, want_jax):
        assert torch.equal(g, w_old)
        assert rel_err(g, w_jax) <= 1e-12
        assert torch.all(g[:, NA - 1] == 0)  # the antenna with no rows
    # the forward equals the reference's products exactly
    jr, ji = jloss.gain_products(jnp.asarray(g_r[0]), jnp.asarray(g_i[0]), jnp.asarray(a0),
                                 jnp.asarray(a1))
    assert np.array_equal(pr[0].detach().numpy(), np.asarray(jr))
    assert np.array_equal(pi[0].detach().numpy(), np.asarray(ji))


def test_serial_gain_products_backward_matches_jax():
    a0, a1, g_r, g_i, dpr, dpi = _problem("dense_b2", 1)
    gr, gi = (torch.as_tensor(x[0]).requires_grad_(True) for x in (g_r, g_i))
    pr, pi = gains.gain_products(gr, gi, torch.as_tensor(a0), torch.as_tensor(a1))
    got = torch.autograd.grad((pr, pi), (gr, gi), (torch.as_tensor(dpr[0]),
                                                   torch.as_tensor(dpi[0])))
    for g, w in zip(got, _jax_grads(a0, a1, g_r, g_i, dpr, dpi)):
        assert rel_err(g, w[0]) <= 1e-12


@pytest.mark.parametrize("kind", ["dense_b2", "padded"])
def test_antenna_csr_lists_each_row_side_once_in_ascending_order(kind):
    a0, a1, *_ = _problem(kind, 1)
    a0[0, 0] = a1[0, 0] = 2  # an autocorrelation row: antenna 2 on both sides
    offsets, rowside, other = (x.numpy() for x in gains.build_antenna_csr(
        torch.as_tensor(a0), torch.as_tensor(a1), NA))
    i0, i1 = a0.reshape(-1), a1.reshape(-1)
    assert offsets[0] == 0 and offsets[-1] == 2 * i0.size == rowside.size
    assert offsets[NA] == offsets[NA - 1]  # antenna 6: no entries
    seen = []
    for ant in range(NA):
        entries = rowside[offsets[ant]:offsets[ant + 1]]
        assert np.all(np.diff(entries) > 0)  # ascending rows, side 0 before side 1
        for rs, o in zip(entries, other[offsets[ant]:offsets[ant + 1]]):
            row, side = divmod(int(rs), 2)
            assert (i0 if side == 0 else i1)[row] == ant
            assert o == (i1 if side == 0 else i0)[row]
            seen.append(int(rs))
    assert sorted(seen) == list(range(2 * i0.size))  # each (row, side) exactly once
    # kept on the index tensor: built once
    t0, t1 = torch.as_tensor(a0), torch.as_tensor(a1)
    assert gains.antenna_csr(t0, t1, NA) is gains.antenna_csr(t0, t1, NA)


@pytest.mark.parametrize("kind", ["dense", "dense_b2", "shared_batched", "padded"])
def test_numpy_loop_in_the_kernels_order_matches_plain(kind):
    """The kernel's arithmetic, in its summation order, in numpy."""
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, 2)
    offsets, rowside, other = (x.numpy() for x in gains.build_antenna_csr(
        torch.as_tensor(a0), torch.as_tensor(a1), NA))
    nbatch = g_r.shape[0]
    pr2, pi2 = dpr.reshape(nbatch, -1, NF), dpi.reshape(nbatch, -1, NF)
    dg_r, dg_i = np.zeros_like(g_r), np.zeros_like(g_i)
    for ant in range(NA):
        for e in range(offsets[ant], offsets[ant + 1]):
            row, side = divmod(int(rowside[e]), 2)
            o = other[e]
            p_r, p_i, gr, gi = pr2[:, row], pi2[:, row], g_r[:, o], g_i[:, o]
            if side == 0:
                dg_r[:, ant] += p_r * gr + p_i * gi
                dg_i[:, ant] += p_r * gi - p_i * gr
            else:
                dg_r[:, ant] += p_r * gr - p_i * gi
                dg_i[:, ant] += p_r * gi + p_i * gr
    want = gains.gain_grad_plain(*(torch.as_tensor(x) for x in (dpr, dpi, g_r, g_i, a0, a1)))
    assert rel_err(dg_r, want[0]) <= 1e-12 and rel_err(dg_i, want[1]) <= 1e-12


def test_kernel_takes_only_cuda_tensors():
    a0, a1, g_r, g_i, dpr, dpi = _problem("dense", 1)
    csr = gains.build_antenna_csr(torch.as_tensor(a0), torch.as_tensor(a1), NA)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gains.gain_grad_kernel(torch.as_tensor(dpr).reshape(1, -1, NF),
                               torch.as_tensor(dpi).reshape(1, -1, NF),
                               torch.as_tensor(g_r), torch.as_tensor(g_i), csr)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dense_b2", "padded"])
def test_cuda_kernel_matches_plain_and_repeats_bit_for_bit(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, 3)
    dev = torch.device("cuda")
    t = [torch.as_tensor(x, device=dev, dtype=dtype) for x in (dpr, dpi, g_r, g_i)]
    ia = [torch.as_tensor(x, device=dev) for x in (a0, a1)]
    csr = gains.antenna_csr(*ia, NA)
    got = gains.gain_grad_kernel(t[0].reshape(3, -1, NF), t[1].reshape(3, -1, NF), t[2], t[3],
                                 csr)
    again = gains.gain_grad_kernel(t[0].reshape(3, -1, NF), t[1].reshape(3, -1, NF), t[2], t[3],
                                   csr)
    want = gains.gain_grad_plain(*t, *ia)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert rel_err(g, w) <= (1e-5 if dtype == torch.float32 else 1e-12)


def test_products_kernel_takes_only_cuda_tensors():
    a0, a1, g_r, g_i, _, _ = _problem("dense", 1)
    index = gains.GainIndex(torch.as_tensor(a0), torch.as_tensor(a1), NA)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gains.gain_products_kernel(torch.as_tensor(g_r), torch.as_tensor(g_i), index)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gain_products_on_the_cpu_match_jax(dtype):
    """``GainProducts`` on the CPU against the reference's ``gain_products``
    and its ``jax.vjp``, on explicit float32 and float64 inputs: forward
    rel 1e-6 (float32; XLA may fuse a product into an FMA) or equal
    (float64 values of this size round alike), gradients rel 1e-5 / 1e-12."""
    a0, a1, g_r, g_i, dpr, dpi = _problem("shared_batched", 1)
    g_r, g_i, dpr, dpi = (x.astype(dtype) for x in (g_r, g_i, dpr, dpi))
    gr, gi = (torch.as_tensor(x[0]).requires_grad_(True) for x in (g_r, g_i))
    pr, pi = gains.gain_products(gr, gi, torch.as_tensor(a0), torch.as_tensor(a1))
    got = torch.autograd.grad((pr, pi), (gr, gi), (torch.as_tensor(dpr[0]),
                                                   torch.as_tensor(dpi[0])))
    jr, ji = jloss.gain_products(jnp.asarray(g_r[0]), jnp.asarray(g_i[0]), jnp.asarray(a0),
                                 jnp.asarray(a1))
    assert pr.dtype == torch.float32 if dtype == np.float32 else torch.float64
    assert np.asarray(jr).dtype == dtype
    fwd = 1e-6 if dtype == np.float32 else 0.0
    assert rel_err(pr.detach(), np.asarray(jr)) <= fwd
    assert rel_err(pi.detach(), np.asarray(ji)) <= fwd
    for g, w in zip(got, _jax_grads(a0, a1, g_r, g_i, dpr, dpi)):
        assert w.dtype == dtype
        assert rel_err(g, w[0]) <= (1e-5 if dtype == np.float32 else 1e-12)


# ---------------------------------------------------------------------- #
# the backward's lists: padding left out, segments
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def packed_core():
    """The HERA core at cut size (25 antennas, 64 channels) packed on the
    CPU with the default shared-basis packing: shared-batched chunks whose
    operator classes are padded."""
    corrupted, comps, _ = demo.build(nside=5, nfreqs=64)
    cal = cal_utils.blank_uvcal_from_uvdata(corrupted)
    spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(cal.ant_array)},
                   device="cpu", nvec_bucketing=True, shared_basis=True)
    assert any((~m.valid).any() for m in spec.meta)
    return spec


def _listed_rows(a0, a1, nants):
    index = gains.antenna_csr(a0, a1, nants)
    rowside = index.rowside.numpy()
    return rowside // 2, rowside % 2


def _assert_lists_valid_rows(a0, a1, nants, valid):
    rows, sides = _listed_rows(a0, a1, nants)
    want = np.flatnonzero(np.asarray(valid).reshape(-1))
    assert sorted(rows[sides == 0]) == sorted(rows[sides == 1]) == list(want)


class _FakeMesh:
    """The coordinates of one rank of a (1, 2) ('data', 'bl') mesh, for
    the block slicing alone (no process group)."""

    mesh_dim_names = mesh.AXES

    def __init__(self, rank):
        self.rank = rank

    def size(self, i):
        return (1, 2)[i]

    def get_coordinate(self):
        return [0, self.rank]

    def get_group(self, name):
        return None


@pytest.mark.parametrize("where", ["packed", "block_views", "mesh_rank_0", "mesh_rank_1"])
def test_antenna_csr_lists_no_padded_row(packed_core, where):
    spec = packed_core
    for chunk, meta in zip(spec.chunks, spec.meta):
        ngrps = chunk.a0.shape[0]
        assert gains.valid_rows(chunk.a0) is not None
        if where == "packed":
            _assert_lists_valid_rows(chunk.a0, chunk.a1, spec.nants, meta.valid)
            # the same rows of a0 without the record: every row listed; a
            # slice of it that was not carried: no list is built
            rows, _ = _listed_rows(chunk.a0.clone(), chunk.a1, spec.nants)
            assert len(rows) == 2 * ngrps
            with pytest.raises(ValueError, match="lost"):
                gains.antenna_csr(chunk.a0[: ngrps // 2], chunk.a1[: ngrps // 2], spec.nants)
        elif where == "block_views":
            gmax = ngrps // chunk.comps.shape[0]
            nbatch, nf, nv = 2, spec.nfreqs, chunk.comps.shape[-1]
            z = torch.zeros
            term = lambda *a: (a[4].sum(dim=(1, 2, 3)),)  # noqa: E731
            tloss._chunk_blocks(term, z(nbatch, spec.nants, nf), z(nbatch, spec.nants, nf),
                                z(nbatch, ngrps, nv), z(nbatch, ngrps, nv),
                                z(nbatch, ngrps, 1, nf), z(nbatch, ngrps, 1, nf),
                                z(nbatch, ngrps, 1, nf), chunk.comps, chunk.a0, chunk.a1,
                                gmax)
            views = chunk.a0._block_views
            assert len(views) == ngrps // gmax
            for (g0, g1), (_, a0_b, a1_b) in views.items():
                _assert_lists_valid_rows(a0_b, a1_b, spec.nants, meta.valid[g0:g1])
        else:
            shard = mesh.MeshShard(_FakeMesh(int(where[-1])), "cpu")
            (padded,), (ngrps_pad,) = calibration._pad_chunks_for_bl(
                [(chunk.comps, chunk.a0, chunk.a1)], 2)
            valid = np.zeros((ngrps_pad, 1), bool)
            valid[:ngrps] = meta.valid
            block = shard.chunk(padded, "cpu")
            _assert_lists_valid_rows(block[1], block[2], spec.nants,
                                     valid[shard.groups(ngrps_pad)])
            # shard_chunk, the time-parallel path's block
            stack = np.zeros((1, ngrps_pad, 1, spec.nfreqs), np.float32)
            (_, b0, b1), *_ = mesh.shard_chunk(_FakeMesh(int(where[-1])), padded, stack,
                                               stack, stack)
            _assert_lists_valid_rows(b0, b1, spec.nants, valid[shard.groups(ngrps_pad)])


@pytest.mark.parametrize("path", ["serial", "time_parallel_blocks", "time_scan"])
def test_every_index_a_descent_gives_the_products_carries_its_valid_rows(monkeypatch, path):
    """The driver's paths on the HERA core at cut size, two times, with the
    shared-basis packing: every index tensor that reaches the gain products
    (the packed chunks, their group-block views) carries the record of its
    rows that hold a baseline, so on the card no list names a padded row."""
    corrupted, comps, _ = demo.build(nside=5, nfreqs=64)
    later = corrupted.copy()
    later.time_array = later.time_array + 2.0
    seen = []
    real = gains.products

    def spy(g_r, g_i, a0, a1):
        seen.append(gains.valid_rows(a0) is not None)
        return real(g_r, g_i, a0, a1)

    monkeypatch.setattr(gains, "products", spy)
    calibration.calibrate_and_model_dpss(
        uvdata=corrupted + later, gains=None, fg_model_comps_dict=comps, maxsteps=4, tol=0.0,
        learning_rate=1e-2, model_regularization="post_hoc", nvec_bucketing=True,
        shared_basis=True, device="cpu", time_parallel=path != "serial",
        init_guesses_from_previous_time_step=path == "time_scan",
        loss_block_ngrps=1 if path == "time_parallel_blocks" else None)
    assert seen and all(seen), f"{seen.count(False)} of {len(seen)} indices carry no record"


def _skewed(rng, nrows=45):
    """Rows of a dense problem plus ``nrows`` rows of antenna 0, and a valid
    mask with two padded rows (antenna 0 with itself)."""
    a0, a1, *_ = _problem("padded", 1)
    s0 = np.concatenate([a0.reshape(-1), np.zeros(nrows, np.int32), [0]])
    s1 = np.concatenate([a1.reshape(-1), 1 + rng.integers(0, NA - 2, nrows), [0]])
    valid = np.ones(len(s0), bool)
    valid[len(a0.reshape(-1)) - 1] = valid[-1] = False
    return s0.reshape(-1, 1).astype(np.int32), s1.reshape(-1, 1).astype(np.int32), valid


@pytest.mark.parametrize("seg_len", [1, 4, 64])
def test_segment_table_covers_every_entry_once_in_order(seg_len):
    a0, a1, valid = _skewed(np.random.default_rng(0))
    index = gains.GainIndex(torch.as_tensor(a0), torch.as_tensor(a1), NA, valid.reshape(-1, 1),
                            seg_len=seg_len)
    offsets = index.offsets.numpy()
    seg_start, seg_ant, seg_slot, multi_ants, multi_slot = (
        x.numpy() for x in (index.seg_start, index.seg_ant, index.seg_slot, index.multi_ants,
                            index.multi_slot))
    assert seg_start[0] == 0 and seg_start[-1] == offsets[-1] == index.rowside.numel()
    assert np.all(np.diff(seg_start) >= 0) and np.all(np.diff(seg_start) <= seg_len)
    assert np.all(np.diff(seg_ant) >= 0)  # antennas in order, segments in order
    for ant in range(NA):
        mine = np.flatnonzero(seg_ant == ant)
        assert len(mine) >= 1  # an antenna with no entries has one empty segment
        covered = np.concatenate([np.arange(seg_start[k], seg_start[k + 1]) for k in mine])
        assert list(covered) == list(range(offsets[ant], offsets[ant + 1]))
        if len(mine) == 1:
            assert seg_slot[mine[0]] == -1 and ant not in multi_ants
        else:
            j = int(np.flatnonzero(multi_ants == ant)[0])
            assert list(seg_slot[mine]) == list(range(multi_slot[j], multi_slot[j + 1]))
    assert index.nmulti == len(multi_ants) and index.nslots == multi_slot[-1]
    assert (index.nmulti > 0) == (seg_len < 64)  # antenna 0's 47 entries: one segment of 64
    assert not np.isin(index.rowside.numpy() // 2, np.flatnonzero(~valid)).any()


def _segmented_walk(index, dpr, dpi, g_r, g_i):
    """The kernel's two passes in torch, in its order: each segment's
    entries summed in list order (pass 1: into dg for an antenna's only
    segment, else into its scratch slot), then each antenna's slots in
    ascending order (pass 2)."""
    nbatch, nants, nf = g_r.shape
    dpr, dpi = dpr.reshape(nbatch, -1, nf), dpi.reshape(nbatch, -1, nf)
    rowside, other, seg_start, seg_ant, seg_slot, multi_ants, multi_slot = (
        t.numpy() for t in index.tables())
    dg = [torch.full_like(g_r, float("nan")) for _ in range(2)]
    part = [torch.zeros(nbatch, index.nslots, nf, dtype=g_r.dtype) for _ in range(2)]
    for k in range(index.nseg):
        acc_r = acc_i = torch.zeros(nbatch, nf, dtype=g_r.dtype)
        for e in range(seg_start[k], seg_start[k + 1]):
            row, side = divmod(int(rowside[e]), 2)
            p_r, p_i, gr, gi = dpr[:, row], dpi[:, row], g_r[:, other[e]], g_i[:, other[e]]
            if side == 0:
                acc_r, acc_i = acc_r + (p_r * gr + p_i * gi), acc_i + (p_r * gi - p_i * gr)
            else:
                acc_r, acc_i = acc_r + (p_r * gr - p_i * gi), acc_i + (p_r * gi + p_i * gr)
        out, at = (dg, seg_ant[k]) if seg_slot[k] < 0 else (part, seg_slot[k])
        out[0][:, at], out[1][:, at] = acc_r, acc_i
    for j, ant in enumerate(multi_ants):
        for which in range(2):
            acc = torch.zeros(nbatch, nf, dtype=g_r.dtype)
            for s in range(multi_slot[j], multi_slot[j + 1]):
                acc = acc + part[which][:, s]
            dg[which][:, ant] = acc
    return dg


@pytest.mark.parametrize("seg_len", [4, 64])
@pytest.mark.parametrize("kind", ["padded", "skewed"])
def test_segmented_walk_in_the_kernels_order_matches_plain(kind, seg_len):
    rng = np.random.default_rng(7)
    if kind == "padded":
        a0, a1, *_ = _problem("padded", 1)
        valid = np.ones(a0.shape, bool)
        valid[-1] = False
    else:
        a0, a1, valid = _skewed(rng)
        valid = valid.reshape(a0.shape)
    nbatch = 2
    g_r = 1 + 0.1 * rng.standard_normal((nbatch, NA, NF))
    g_i = 0.1 * rng.standard_normal((nbatch, NA, NF))
    dpr = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    dpi = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    dpr[:, ~valid] = dpi[:, ~valid] = 0.0  # the descent's padded cotangents
    t = [torch.as_tensor(x) for x in (dpr, dpi, g_r, g_i)]
    ia0, ia1 = torch.as_tensor(a0), torch.as_tensor(a1)
    index = gains.GainIndex(ia0, ia1, NA, valid, seg_len=seg_len)
    if kind == "skewed":
        assert (index.nmulti > 0) == (seg_len == 4)
    got = _segmented_walk(index, *t)
    want = gains.gain_grad_plain(*t, ia0, ia1)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()  # every antenna written
        assert rel_err(g, w) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_products_kernel_equals_the_torch_ops(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    a0, a1, g_r, g_i, _, _ = _problem("dense_b2", 3)
    dev = torch.device("cuda")
    gr, gi = (torch.as_tensor(x, device=dev, dtype=dtype) for x in (g_r, g_i))
    ia = [torch.as_tensor(x, device=dev) for x in (a0, a1)]
    got = gains.products(gr, gi, *ia)
    want = gains._products(gr, gi, *ia)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
