"""idle_share.nacf (cell nacf-msrvtt.batch-8192): the share of the traced
window in which no device operation ran, in %."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
