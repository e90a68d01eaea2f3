"""capture_s: seconds the captioner's CUDA graph captures took in set-up
(Graph.capture_s summed over its encodes' and its decode's graphs)."""

import math


def read(run):
    return None if math.isnan(run.capture_s) else run.capture_s
