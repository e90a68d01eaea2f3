"""decode_roofline.nar: the least time of the NACF decodes' work (costs.py)
over their device spans (CUDA events around each decode call), in %."""

from benchmark.readers import decode_roofline


def read(run):
    return decode_roofline(run, "nacf")
