"""stage_host_ms.nacf: mean host ms a request spends staging its features
(the program's span ``navc.stage`` in StreamingCaptioner: the wait for a
page-locked slot, the copy into it, the copies to the card queued), over the
requests of the traced window."""

from benchmark.spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "navc.stage")
