"""live_row_share.nacf: the share of the NAR decode's walk rows (K1 and K2,
canvas and query rows) that lie within each canvas's extent and each
sparse step's used slots, the rows the walk computes, from the program's
counter ``navc.walk.live_rows`` over the traced window, in %. A program
that keeps no such counter reads nothing."""

from benchmark.spans import counter_mean


def read(run):
    return counter_mean(run, "navc.walk.live_rows", 100.0)
