#!/usr/bin/env python
"""Shell entry point: DPSS-basis calibration + foreground modeling on the
PyTorch/CUDA port (calamity_tpu_torch).

Same arguments as scripts/calibrate_and_model_dpss.py, plus ``--device``
(default cuda; pass ``--device cpu`` to run on the CPU).
"""


def main():
    from calamity_tpu_torch.calibration import (
        dpss_fit_argparser,
        read_calibrate_and_model_dpss,
    )

    args = dpss_fit_argparser().parse_args()
    read_calibrate_and_model_dpss(**vars(args))


if __name__ == "__main__":
    main()
