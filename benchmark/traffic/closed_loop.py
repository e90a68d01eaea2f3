"""Closed-loop captioning in bulk: one client keeps the captioner's
pipeline full with whole requests of ``videos`` videos, cycling through
``distinct`` requests made at set-up, and sends the next as soon as
``submit`` returns (which waits on the oldest of ``depth`` requests in
flight). The window ends when the last request sent before ``--seconds``
has come back, so it holds whole requests only.

Parameters: videos, distinct, depth, check_videos (the videos of each
request, drawn from the seed, that the check holds against the reference),
warm_requests (requests the warm-up sends, at least every pool through
every page-locked slot).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import inputs
from benchmark.harness import Request


class Client:
    def __init__(self, params, config, seed, device):
        self.params, self.seed = params, seed
        m = config["student"]["model"]
        self.pools = [inputs.make_videos(m, params["videos"], seed, inputs.FEATURE_STREAM + i,
                                         device) for i in range(params["distinct"])]

    def check_rows(self, pool: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, inputs.SCHEDULE_STREAM, pool])
        n = self.params["videos"]
        return np.sort(rng.choice(n, size=min(n, self.params["check_videos"]), replace=False))

    def warm(self, cap) -> None:
        """The loop's own traffic for ``warm_requests`` requests (at least
        every pool through every page-locked slot), then drain."""
        n = max(len(self.pools), self.params["depth"] + 1, self.params.get("warm_requests", 0))
        for i in range(n):
            cap.submit(*self.pools[i % len(self.pools)])
        cap.flush()

    def window(self, cap, seconds: float, span):
        reqs, by_ticket = [], {}
        rows = np.arange(self.params["videos"])
        t0 = time.perf_counter()

        def collect(done):
            now = time.perf_counter() - t0
            for ticket, hyp in done:
                by_ticket[ticket].done, by_ticket[ticket].hyp = now, hyp

        i = 0
        while time.perf_counter() - t0 < seconds:
            pool = i % len(self.pools)
            req = Request(pool=pool, rows=rows, due=time.perf_counter() - t0)
            req.sent = req.due
            with span("bench.submit"):
                ticket, done = cap.submit(*self.pools[pool])
            by_ticket[ticket] = req
            reqs.append(req)
            collect(done)
            i += 1
        with span("bench.flush"):
            collect(cap.flush())
        return reqs
