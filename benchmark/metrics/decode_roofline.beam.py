"""decode_roofline.beam: the least time of the beam decodes' work over the
steps their captions needed (costs.py) over their device spans, in %."""

from benchmark.readers import decode_roofline


def read(run):
    return decode_roofline(run, "beam")
