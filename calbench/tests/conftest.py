"""Path set-up of the benchmark's own tests (run them from the checkout's root:
``python -m pytest calbench/tests -q``)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
