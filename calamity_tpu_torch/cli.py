"""Console entry point for the DPSS calibration CLI on the torch port.

Same behavior as scripts/calibrate_and_model_dpss_torch.py, installable as
the ``calibrate_and_model_dpss_torch`` console script.
"""

from __future__ import annotations

from . import calibration


def main(argv=None):
    ap = calibration.dpss_fit_argparser()
    args = ap.parse_args(argv)
    calibration.read_calibrate_and_model_dpss(**vars(args))


if __name__ == "__main__":  # pragma: no cover
    main()
