"""Puts the benchmark's directory and the repository's root on sys.path,
as portbench/run.py does."""

import os
import sys

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
for p in (ROOT, PORTBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
