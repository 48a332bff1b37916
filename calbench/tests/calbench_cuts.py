"""Sizes and seeds the benchmark's CPU tests share."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the numbers compared at the cut's size, on the CPU's float32 (the cells'
# own limits hold the card's runs at full width): sound cut runs read
# start_rel and start_rel_max <= 1e-6 and end_rel <= 4e-5, the control 4e-4,
# 4e-4 and 3e-2 and more; resid_ratio reads at most 1.9e-4 (the full array's
# and the core's cuts) and 1.7e-3 (the campaign's) sound, and 9.6e-4,
# 1.0e-3 and 3.0e-3 with the float32 phase frozen
CUT_LIMITS = {"start_rel": 1e-5, "start_rel_max": 1e-5, "end_rel": 1e-4}
# a cut of each cell that a CPU runs in seconds: the full array's lattice at
# 2 rings, the core's grid at 5 x 5, 64 channels, 300 steps a phase
CUTS = {
    "hera_full.fit1": dict(array={"rings": 2}, nfreqs=64, steps=300, warmup_steps=3,
                           limits={**CUT_LIMITS, "resid_ratio": 4e-4}),
    "hera_core.fit1": dict(array={"nside": 5}, nfreqs=64, steps=300, warmup_steps=3,
                           limits={**CUT_LIMITS, "resid_ratio": 4e-4}),
    "hera_full.campaign8": dict(array={"rings": 2}, nfreqs=64, steps=300, warmup_steps=3,
                                limits={**CUT_LIMITS, "resid_ratio": 2.2e-3}),
}
SEED = 2 ** 31 + 12345  # past 32 signed bits: a run takes any seed up to 2**63
