"""The benchmark's own tests: CPU tests of the reference against the port,
the traffic generators, the trace arithmetic and the correctness check;
`gpu` tests decide inside the test whether a card is there. Run them
from the repository's root: python -m pytest perfbench/tests -q"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
