"""Open-loop captioning: independent uploads arrive as a Poisson process
at ``rate`` requests a second, each of a size drawn from ``sizes`` videos,
its features a slice of one pool of ``pool_videos`` videos made at set-up.

Every seed gets the same work: the arrivals and sizes come from
``schedule_seed``, stratified in blocks of ``block`` requests (each block
takes the sizes in equal shares and the inter-arrival gaps at the
exponential law's ``block`` evenly spaced quantiles, both permuted); the
run's seed draws the weights, the pool's features and each request's place
in the pool. The client submits every request that is due; when none is,
it drains the captioner with ``flush()`` (the captioner has no
non-blocking poll), or sleeps until the next is due. Each request is timed
from its due time to its hypotheses on the host. The check holds every
answer against the reference's captions of the whole pool.

Parameters: rate, sizes, pool_videos, block, schedule_seed, depth.
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
        self.pools = [inputs.make_videos(m, params["pool_videos"], seed, inputs.FEATURE_STREAM,
                                         device)]

    def check_rows(self, pool: int) -> np.ndarray:
        return np.arange(self.params["pool_videos"])

    def schedule(self, seconds: float):
        """[(due seconds, first pool row, videos)] of the window: the
        blocks that round(rate x seconds) requests fill."""
        p = self.params
        block = int(p["block"])
        blocks = max(1, int(round(p["rate"] * seconds / block)))
        rng = np.random.default_rng([p["schedule_seed"], inputs.SCHEDULE_STREAM])
        place = np.random.default_rng([self.seed, inputs.SCHEDULE_STREAM])
        quantiles = -np.log1p(-(np.arange(block) + 0.5) / block) / p["rate"]
        gaps = np.concatenate([rng.permutation(quantiles) for _ in range(blocks)])
        sizes = np.concatenate([rng.permutation(np.resize(np.asarray(p["sizes"]), block))
                                for _ in range(blocks)])
        due = np.cumsum(gaps) - gaps[0]
        first = [int(place.integers(0, p["pool_videos"] - s + 1)) for s in sizes]
        return [(float(d), f, int(s)) for d, f, s in zip(due, first, sizes)]

    def _request(self, first: int, size: int):
        feats, cat = self.pools[0]
        part = slice(first, first + size)
        return [f[part] for f in feats], cat[part]

    def warm(self, cap) -> None:
        """Every size through every page-locked slot (depth + 1 requests of
        a size in a row take the slots in turn), then drain."""
        for size in self.params["sizes"]:
            for _ in range(self.params["depth"] + 1):
                cap.submit(*self._request(0, size))
        cap.flush()

    def window(self, cap, seconds: float, span):
        plan = self.schedule(seconds)
        reqs, by_ticket = [], {}
        t0 = time.perf_counter()
        outstanding = 0

        def collect(done):
            nonlocal outstanding
            now = time.perf_counter() - t0
            for ticket, hyp in done:
                by_ticket[ticket].done, by_ticket[ticket].hyp = now, hyp
                outstanding -= 1

        nxt = 0
        while nxt < len(plan) or outstanding:
            now = time.perf_counter() - t0
            if nxt < len(plan) and plan[nxt][0] <= now:
                due, first, size = plan[nxt]
                req = Request(pool=0, rows=np.arange(first, first + size), due=due, sent=now)
                with span("bench.submit"):
                    ticket, done = cap.submit(*self._request(first, size))
                by_ticket[ticket] = req
                reqs.append(req)
                outstanding += 1
                nxt += 1
                collect(done)
            elif outstanding:
                with span("bench.flush"):
                    collect(cap.flush())
                outstanding = 0  # flush drains the captioner: what it did not return never comes
            else:
                with span("bench.sleep"):
                    time.sleep(max(0.0, plan[nxt][0] - now))
        return reqs
