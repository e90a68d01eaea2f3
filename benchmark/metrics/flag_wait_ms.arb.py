"""flag_wait_ms.arb: mean host ms a request spends waiting for the beam
search's lagged done flags (the program's span ``navc.decode.flag_wait``
around each read in graphs.lagged_blocks), over the requests of the traced
window."""

from benchmark.spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "navc.decode.flag_wait")
