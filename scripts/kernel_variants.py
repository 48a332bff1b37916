#!/usr/bin/env python
"""Build variants of a chunk-loss kernel side by side and time them in
turns, on one GPU.

    python3 scripts/kernel_variants.py [--kernel fused|shared] [--sum-pair SOURCE]
        NAME=SOURCE[:NVCC_FLAGS] ...

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each SOURCE is a variant of ``calamity_tpu_torch/csrc/fused_chunk_loss.cu``
(``--kernel fused``, the default) or of ``csrc/shared_chunk_loss.cu``
(``--kernel shared``) with the same C interface (an empty SOURCE means
that file itself);
NVCC_FLAGS, space-separated, are added to the package's own (``-D...``
switches, for one). The variants are built in parallel into
``calamity_tpu_torch/_build/variants/``, each build's ``-Xptxas -v``
report beside its library as ``NAME.log``, and one line
per variant gives each template instance's registers and spill bytes
(``kernel|wide:<slices per tile><comps type><mode>``: mode 0 the loss only, 1 with the
gain-product gradients, 2 with every gradient; 3 the "sum" prior's forward, 6 and 7 its
one-pass forward with the pieces of the gain-product or every gradient). Each variant is held
against the plain version at ragged shapes, a group-block view, an
unaligned comps offset, wide bases and the wide-row kernel (loss rel 1e-5,
gradients rel 1e-4, as in ``chip_smoke.py``'s phase 3; a shape a variant
has no launch plan for is named and passed over); those that agree
are timed at the main chunk (2016 x 1536 x 118; N = 8 and 1 slices;
float32 and bfloat16 comps) with CUDA events, the loss with every gradient
and the loss only, in turns over the variants, twice. Every time stands
beside the card's name and power limit.

With ``--sum-pair SOURCE`` (an earlier fused source whose "sum" gradients
took a second launch: modes 3 and 5 of its C interface, which also took
the cotangents) the "sum" prior's chunk work is timed too, at the main
chunk, in turns: that source's forward plus backward against each
variant's one pass with every gradient plus the combine, the device alone
(replayed from a CUDA graph) and through the wrappers, each beside its
bound; the pair is first held against the plain version. Save the earlier
source with ``git show REV:calamity_tpu_torch/csrc/fused_chunk_loss.cu``
under ``calamity_tpu_torch/_build/``.

With ``--kernel shared`` each variant is held against the plain version
(``chip_smoke.compare_shared``: every instance, two launches equal to the
bit, padding's gradients zero) at phase 3s's ragged shapes (N = 3; a shape
wider than a variant takes is named and passed over) and at the HERA
core's chunk 1 at N = 8, then timed: the HERA core's step (its four packed
chunks with their padding, ``chip_smoke.hera_packed_chunks``), each of the
full HERA array's 18 chunks with its padding and its whole step of 18
launches (``chip_smoke.hera_full_build``, built on the host first, about a
minute); the loss with every gradient, N = 1 and 8, float32 and bfloat16
comps, replayed from a CUDA graph (the device alone) and through the
wrapper, against the bound, in turns over the variants, twice. A table of
the full array's chunks follows (each chunk's shape, bound and launch plan,
and each variant's device-alone time, the better of its two rounds), and
for each variant the SASS of its sliced instances (``cuobjdump -sass`` of
its library): the instructions of the channel-tile loop (the loop that
holds the cluster barriers; inner loops counted once), in all and by kind.
With ``--json PATH`` the timings and counts are also written there. To time
an earlier version of the source beside the current one, save it with
``git show REV:calamity_tpu_torch/csrc/shared_chunk_loss.cu`` under a
directory git ignores (``calamity_tpu_torch/_build/``, or an unpacked
checkout).
"""

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from calamity_tpu_torch.ops import _build, fused  # noqa: E402

MAIN_SHAPE = (2016, 1536, 118)
CHECKS = (  # (nbatch, shape, weights dtype, keyword arguments of chip_smoke.compare)
    (3, (5, 37, 3), torch.float32, {}),
    (1, (1, 1, 1), torch.bfloat16, {}),
    (3, (7, 129, 130), torch.bfloat16, {"extra": 5}),
    (9, (3, 50, 300), torch.float32, {}),
    (3, (7, 129, 118), torch.bfloat16, {"odd_offset": True}),
    (8, (2, 16, 4000), torch.float32, {}),
    (8, (64, 1536, 118), torch.float32, {}),
    (1, (64, 1536, 118), torch.bfloat16, {}),
    (3, (2, 3, 60000), torch.float32, {}),
)


def build(variants, kernel):
    nvcc = _build.find_nvcc()
    sodir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(sodir, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        so = os.path.join(sodir, f"{name}.so")
        # each variant library also holds the package's other kernels
        others = [s for s in _build.sources()
                  if s.endswith(".cu") and os.path.basename(s) != f"{kernel}.cu"]
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *flags, "-o", so, src, *others]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, time.time())
    libs = {}
    for name, (proc, so, t0) in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(sodir, f"{name}.log"), "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            print(f"{name}: BUILD FAILED\n{log[-4000:]}", flush=True)
            continue
        print(f"{name}: built in {time.time() - t0:.1f} s; " + " ".join(cs.registers(log, kernel)),
              flush=True)
        libs[name] = _build.KernelLibrary(so, time.time() - t0, log)
    return libs


class SumPair:
    """An earlier fused source's "sum" forward (mode 3) and backward with
    every gradient (mode 5), through its own C interface (with the
    cotangents after the scratch buffer), built with the package's other
    sources."""

    def __init__(self, src):
        nvcc = _build.find_nvcc()
        sodir = os.path.join(_build.BUILD_DIR, "variants")
        os.makedirs(sodir, exist_ok=True)
        so = os.path.join(sodir, "sum_pair.so")
        others = [x for x in _build.sources()
                  if x.endswith(".cu") and os.path.basename(x) != "fused_chunk_loss.cu"]
        t0 = time.time()
        out = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, src, *others],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"sum pair: BUILD FAILED\n{(out.stdout + out.stderr)[-4000:]}")
        print(f"sum pair: built in {time.time() - t0:.1f} s; "
              + " ".join(cs.registers(out.stdout + out.stderr)), flush=True)
        lib = ctypes.CDLL(so)
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fcl_plan.argtypes = [ll] * 4 + [ci, ci, vp, ctypes.POINTER(ll)]
        lib.fused_chunk_loss.argtypes = (
            [vp, ci] + [vp] * 5 + [ll] * 3 + [vp, ci] + [ll] * 3 + [vp] * 6 + [ll] * 4 + [ci, vp])
        self.lib = lib

    def run(self, args, mode, cot=None):
        """(terms (3, N) or None, dcoeffs, dpr, dpi) of ``mode`` 3 or 5."""
        coeffs2, pr, pi, dr, di, w, comps = args
        ngrps, nfreqs, nvecs = comps.shape
        nbatch = coeffs2.shape[1]
        cdt = int(comps.dtype != torch.float32)
        plan = (ctypes.c_longlong * 6)()
        assert self.lib.fcl_plan(nbatch, ngrps, nfreqs, nvecs, cdt, mode, comps.data_ptr(),
                                 plan) == 0

        def out(*shape):
            return torch.empty(shape, dtype=torch.float32, device=comps.device)

        partials = out(3, nbatch, ngrps) if mode == fused.SUM_FWD else None
        dco = dpr = dpi = None
        if mode == fused.SUM_ALL:
            dco, dpr, dpi = out(2, nbatch, ngrps, nvecs), out(*pr.shape), out(*pr.shape)
        scratch = None if plan[4] else out(ngrps * nvecs * 2 * plan[0])

        def ptr(t):
            return None if t is None else t.data_ptr()

        err = self.lib.fused_chunk_loss(
            comps.data_ptr(), cdt, coeffs2.data_ptr(), pr.data_ptr(), pi.data_ptr(),
            dr.data_ptr(), di.data_ptr(), *dr.stride(), w.data_ptr(),
            int(w.dtype != torch.float32), *w.stride(), ptr(partials), ptr(dco), ptr(dpr),
            ptr(dpi), ptr(scratch), ptr(cot), nbatch, ngrps, nfreqs, nvecs, mode,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"sum pair launch failed: CUDA error {err}"
        return (None if partials is None else partials.sum(dim=2)), dco, dpr, dpi

    def step(self, args, cot):
        self.run(args, fused.SUM_FWD)
        return self.run(args, fused.SUM_ALL, cot)


def time_sum(pair, libs, agree, card):
    """The "sum" prior's chunk work at the main chunk, in turns: the earlier
    source's forward plus backward, each variant's one pass plus combine."""
    f32 = torch.float32
    for nbatch in (8, 1):
        for cdt in (f32, torch.bfloat16):
            args = cs.batched_inputs(nbatch, *MAIN_SHAPE, cdt, f32, 1)
            cot = cs.sum_cotangents(nbatch, args[0].device, 0)["random"]
            terms, *grads = pair.step(args, cot)
            want = fused.loss_and_grads_plain(*args, mode=fused.SUM_ALL, cot=cot)[1:]
            want_terms = fused.loss_and_grads_plain(*args, mode=fused.SUM_FWD)[0]
            errs = [cs.rel(pair.run(args, fused.SUM_FWD)[0][0], want_terms[0])]
            errs += [cs.rel(g, w) for g, w in zip(grads, want)]
            assert max(errs[1:]) <= 1e-4 and errs[0] <= 1e-5, errs
            pair_bound = cs.bound(args, False, sums=True)[0] + cs.bound(args, True, sums=True)[0]
            one_bound = cs.one_pass_bound(args, True)[0] + cs.combine_bound(args, True)[0]
            tag = f"N={nbatch} {str(cdt)[6:]} comps"
            print(f"{tag}: the sum pair against plain, rel chi2, dcoeffs, dpr, dpi "
                  + ", ".join(f"{e:.2e}" for e in errs), flush=True)

            def one_pass():
                pieces = fused.loss_and_grads_kernel(*args, mode=fused.SUM_FWD_ALL)[1:]
                return fused.combine_kernel(*pieces, cot)

            for rnd in range(2):
                dev, ms = cs.cuda_graph_ms(lambda: pair.step(args, cot)), \
                    cs.cuda_median_ms(lambda: pair.step(args, cot))
                print(f"{tag}, round {rnd}, sum pair (forward + backward): the device alone "
                      f"{dev:.4f} ms, through the wrapper {ms:.4f} ms, bound {pair_bound:.4f}; "
                      f"{card}", flush=True)
                for name in agree:
                    _build._LOADED[:] = [libs[name]]
                    dev, ms = cs.cuda_graph_ms(one_pass), cs.cuda_median_ms(one_pass)
                    print(f"{tag}, round {rnd}, {name} (one pass + combine): the device alone "
                          f"{dev:.4f} ms, through the wrappers {ms:.4f} ms, bound "
                          f"{one_bound:.4f}; {card}", flush=True)
            del args
            torch.cuda.empty_cache()


def check_shared(libs):
    """The variants that agree with the plain version at the shared-basis
    kernel's checks (a ragged shape wider than a variant takes, which it
    refuses as an invalid launch, is named and passed over)."""
    agree = []
    quiet, cs.log = cs.log, (lambda msg="": None)
    chunks, _ = cs.hera_packed_chunks()
    nu, nf, nv = cs._HERA["comps_shapes"][1]
    for name, lib in libs.items():
        _build._LOADED[:] = [lib]
        try:
            for cdt in (torch.float32, torch.bfloat16):
                for u, gmax, f, v in cs.ragged_cases(cdt):
                    try:
                        cs.compare_shared("check", 3, u, f, v, cs.ragged_valid(u, gmax), cdt)
                    except RuntimeError as exc:
                        if "invalid argument" not in str(exc):
                            raise
                        print(f"{name}: no launch for U={u} gmax={gmax} F={f} V={v} "
                              f"{str(cdt)[6:]} comps", flush=True)
                cs.compare_shared("HERA chunk 1", 8, nu, nf, nv, chunks[1][2], cdt)
                torch.cuda.empty_cache()
            agree.append(name)
            print(f"{name}: agrees with the plain version", flush=True)
        except Exception:  # report and go on with the other variants
            print(f"{name}: DISAGREES\n{traceback.format_exc()[-3000:]}", flush=True)
    cs.log = quiet
    return agree


def _time_in_turns(libs, agree, tag, fn, bound_ms, by, card, per_sample=5):
    """Device-alone (replayed from a CUDA graph) and wrapper ms of ``fn``,
    in turns over the variants, twice; returns each variant's device-alone
    ms of the two rounds."""
    dev = collections.defaultdict(list)
    for rnd in range(2):
        for name in agree:
            _build._LOADED[:] = [libs[name]]
            dev_ms = cs.cuda_graph_ms(fn, n=5 if per_sample == 1 else 20, per_sample=per_sample)
            ms = cs.cuda_median_ms(fn, n=5 if per_sample == 1 else 20, per_sample=per_sample)
            dev[name].append(dev_ms)
            print(f"{tag}, round {rnd}, {name}: the device alone {dev_ms:.4f} ms (share of the "
                  f"{bound_ms:.4f} ms bound, {by}, {bound_ms / dev_ms:.3f}), through the wrapper "
                  f"{ms:.4f} ms; {card}", flush=True)
    return dict(dev)


def tile_loop_counts(sass):
    """Counts of one kernel function's SASS (``cuobjdump -sass`` text): the
    instructions of the channel-tile loop, the body of the longest backward
    branch whose body holds a cluster barrier (inner loops counted once),
    in all and by kind (the opcode's first word, NOPs left out), and of the
    whole function."""
    code = []  # (address, opcode, text)
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            text = m.group(2).strip()
            words = [w for w in text.split() if not w.startswith("@")]
            if words:
                code.append((int(m.group(1), 16), words[0], text))
    loop = None
    for addr, op, text in code:
        if op.startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", text)
            if target and int(target.group(1), 16) < addr:
                body = [c for c in code if int(target.group(1), 16) <= c[0] <= addr]
                if any("CGABAR" in c[1] for c in body) and (loop is None or len(body) > len(loop)):
                    loop = body
    kinds = collections.Counter(c[1].split(".")[0] for c in (loop or ()) if c[1] != "NOP")
    return {"loop": sum(kinds.values()), "function": sum(c[1] != "NOP" for c in code),
            "kinds": dict(kinds.most_common())}


def sass_counts(libs):
    """Per variant, the SASS counts (:func:`tile_loop_counts`) of its
    sliced instances with every gradient, float32 and bfloat16 comps."""
    out = {}
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    for name, lib in libs.items():
        text = subprocess.run([cuobjdump, "-sass", lib.path], capture_output=True,
                              text=True).stdout
        funcs = re.split(r"\n\s*Function : ", text)
        for func in funcs[1:]:
            fname = func.split("\n", 1)[0].strip()
            m = re.search(r"shared_chunk_loss_slicedI(f|13__nv_bfloat16)Li2EE", fname)
            if m:
                dt = "float32" if m.group(1) == "f" else "bfloat16"
                c = tile_loop_counts(func)
                out[f"{name} {dt}"] = c
                top = ", ".join(f"{k} {v}" for k, v in list(c["kinds"].items())[:14])
                print(f"SASS {name}, sliced, {dt} comps, every gradient: channel-tile loop "
                      f"{c['loop']} instructions ({top}); function {c['function']}", flush=True)
    return out


def time_shared(libs, agree, card):
    """In turns over the variants, device-alone and wrapper ms against the
    bound: the HERA core's step of four packed chunks; each of the full
    HERA array's 18 chunks and its step of 18 launches; N = 1 and 8,
    float32 and bfloat16 comps, the loss with every gradient. Returns the
    full array's table."""
    from calamity_tpu_torch.ops import shared

    chunks, _ = cs.hera_packed_chunks()
    shapes = cs._HERA["comps_shapes"]
    table = []

    def run(ops):
        return lambda: [shared.loss_and_grads_kernel(*a, m) for a, m in ops]

    def bound(ops):
        bounds = [cs._shared_bound(a, m) for a, m in ops]
        by = "bytes" if all(b[1] == "bytes" for b in bounds) else "operations"
        return sum(b[0] for b in bounds), by

    for nbatch in (1, 8):
        for cdt in (torch.float32, torch.bfloat16):
            tag = f"N={nbatch} {str(cdt)[6:]} comps"
            ops = [cs.shared_inputs(nbatch, nu, nf, nv, valid, cdt, cs.SEED + 13 * nbatch + c)
                   for c, ((nu, nf, nv), (_, _, valid)) in enumerate(zip(shapes, chunks))]
            _time_in_turns(libs, agree, f"HERA step, 4 chunks, {tag}", run(ops), *bound(ops), card)
            del ops
            torch.cuda.empty_cache()
    spec = cs.hera_full_build()["spec"]
    for nbatch in (1, 8):
        for cdt in (torch.float32, torch.bfloat16):
            tag = f"N={nbatch} {str(cdt)[6:]} comps"
            for c, ch in enumerate(spec.chunks):
                nu, nv = ch.comps.shape[0], ch.comps.shape[-1]
                valid = spec.meta[c].valid.reshape(-1)
                shape = (nu, len(valid) // nu, nv)
                ops = [cs.shared_inputs(nbatch, nu, cs.NFREQS, nv, valid, cdt, cs.SEED + c,
                                        on_card=True)]
                b_ms, by = bound(ops)
                dev = _time_in_turns(libs, agree, f"full array chunk {c} (U, gmax, V) = {shape}, "
                                     f"{tag}", run(ops), b_ms, by, card, per_sample=2)
                plans = {name: libs[name].shared_plan(nbatch, len(valid), cs.NFREQS, nv, nu,
                                                      int(cdt != torch.float32), fused.LOSS_ALL)
                         for name in agree}
                table.append({"chunk": c, "shape": shape, "valid": int(valid.sum()),
                              "nbatch": nbatch, "comps": str(cdt)[6:], "bound_ms": b_ms,
                              "by": by, "device_ms": {k: min(v) for k, v in dev.items()},
                              "plans": plans})
                del ops
                torch.cuda.empty_cache()
            ops = [cs.shared_inputs(nbatch, ch.comps.shape[0], cs.NFREQS, ch.comps.shape[-1],
                                    spec.meta[c].valid.reshape(-1), cdt, cs.SEED + c,
                                    on_card=True)
                   for c, ch in enumerate(spec.chunks)]
            b_ms, by = bound(ops)
            dev = _time_in_turns(libs, agree, f"full array step, {len(ops)} launches, {tag}",
                                 run(ops), b_ms, by, card, per_sample=1)
            table.append({"chunk": "step", "shape": None, "nbatch": nbatch,
                          "comps": str(cdt)[6:], "bound_ms": b_ms, "by": by,
                          "device_ms": {k: min(v) for k, v in dev.items()}})
            del ops
            torch.cuda.empty_cache()
    print_table(table, agree, card)
    return table


def print_table(table, agree, card):
    """The full array's chunks, one line each: chunk, (U, gmax, V), valid
    groups, N, comps, bound, each variant's device-alone ms (the better of
    two rounds) and launch plan (blocks an SM, shared memory, cluster)."""
    print(f"TABLE full array, the device alone, ms (better of two rounds); {card}", flush=True)
    print("TABLE chunk | (U, gmax, V) | valid | N | comps | bound | "
          + " | ".join(f"{n} ms (blocks/SM, smem B, cluster)" for n in agree), flush=True)
    for row in table:
        cells = []
        for name in agree:
            plan = row.get("plans", {}).get(name)
            extra = (f" ({plan['blocks_per_sm']}, {plan['smem_bytes']}, {plan['cluster']})"
                     if plan else "")
            cells.append(f"{row['device_ms'][name]:.4f}{extra}")
        print(f"TABLE {row['chunk']} | {row['shape']} | {row.get('valid', '')} | "
              f"{row['nbatch']} | {row['comps']} | {row['bound_ms']:.4f} | " + " | ".join(cells),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fused", "shared"), default="fused")
    ap.add_argument("--sum-pair", metavar="SOURCE",
                    help='an earlier fused source whose "sum" gradients took a second launch')
    ap.add_argument("--json", metavar="PATH", help="also write the shared timings and counts here")
    ap.add_argument("variants", nargs="+", metavar="NAME=SOURCE[:NVCC_FLAGS]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    kernel = f"{args.kernel}_chunk_loss"
    variants = {}
    for arg in args.variants:
        name, _, spec = arg.partition("=")
        src, _, flags = spec.partition(":")
        variants[name] = (src or os.path.join(_build.CSRC_DIR, f"{kernel}.cu"), flags.split())
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    pair = SumPair(args.sum_pair) if args.sum_pair else None
    libs = build(variants, kernel)
    if args.kernel == "shared":
        sys.path.insert(0, os.path.join(REPO, "scripts"))  # hera_core_demo_torch
        sass = sass_counts(libs)
        table = time_shared(libs, check_shared(libs), card)
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"card": card, "sass": sass, "table": table}, fh, indent=1)
        return
    f32, bf16 = torch.float32, torch.bfloat16
    agree = []
    quiet, cs.log = cs.log, (lambda msg="": None)
    for name, lib in libs.items():
        _build._LOADED[:] = [lib]
        try:
            for cdt in (f32, bf16):
                for nbatch, shape, wdt, kw in CHECKS:
                    try:
                        cs.compare(nbatch, shape, cdt, wdt, **kw)
                    except ValueError as exc:  # a variant without a plan for this shape
                        if "no launch plan" not in str(exc):
                            raise
                        print(f"{name}: no launch plan for N={nbatch} {shape}", flush=True)
            agree.append(name)
            print(f"{name}: agrees with the plain version", flush=True)
        except Exception:  # report and go on with the other variants
            print(f"{name}: DISAGREES\n{traceback.format_exc()[-3000:]}", flush=True)
    cs.log = quiet
    for nbatch in (8, 1):
        for cdt in (f32, bf16):
            args = cs.batched_inputs(nbatch, *MAIN_SHAPE, cdt, f32, 1)
            bound_ms = cs.bound(args, True)[0]
            for rnd in range(2):
                for name in agree:
                    lib = libs[name]
                    _build._LOADED[:] = [lib]
                    plan = lib.plan(nbatch, *MAIN_SHAPE, int(cdt != f32), fused.LOSS_ALL,
                                    args[6].data_ptr())
                    ms = [cs.cuda_median_ms(lambda m=m: fused.loss_and_grads_kernel(*args, mode=m))
                          for m in (fused.LOSS_ALL, fused.LOSS_ONLY)]
                    print(f"N={nbatch} {str(cdt)[6:]} comps, round {rnd}, {name}: loss+gradients "
                          f"{ms[0]:.4f} ms (share of the {bound_ms:.4f} ms bound "
                          f"{bound_ms / ms[0]:.3f}), loss only {ms[1]:.4f} ms; rows "
                          f"{plan['rows']}, {plan['smem_bytes']} B "
                          f"shared; {card}", flush=True)
            del args
            torch.cuda.empty_cache()
    if pair is not None:
        time_sum(pair, libs, agree, card)


if __name__ == "__main__":
    main()
