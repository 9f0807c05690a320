"""The benchmark's tests import its harness (``portbench/``), the port
(``src/``) and the small sizes beside them."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
for p in (HERE, PB, os.path.join(os.path.dirname(PB), "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
