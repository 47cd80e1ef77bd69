"""Open-loop Poisson replayer into ``StreamingSolverService``.

Requests arrive on a schedule fixed in set-up and are submitted when they
fall due, between service steps, whether or not earlier ones are done:
independent users.  The schedule is ``streaming.make_poisson_trace``'s
(exponential gaps at the mix's rate; n uniform in [min_n, max_n]; circle
and random instances alternating, RAW distances), drawn so that every seed
gets the same multiset of gaps and sizes in another order: the gaps are
the exponential distribution's K quantiles and the sizes the uniform's,
K = rate x window, permuted by the seed; the coordinates and each
request's colony seed come from the seed.  So two seeds offer the same
work, and the seed changes only its order and its instances.

Set-up builds the service at the configuration's settings, warms its
program cache for the mix's buckets (``warm_programs``, as
``solve_serve --warmup`` does) and replays ``warmup_s`` seconds of the
same mix from another stream of the seed, drained, so the kernels are
built and the CUDA graphs of the common slot patterns captured before the
window.  Every request is timed from when it fell due to its result in
hand on the host; one that is refused or unfinished when the drain limit
ends is failed and missing.

``correct``: every completed request has the budget's iteration count and
returns a permutation of its cities whose length is the reference's
length of that tour; a sample drawn from the seed (the largest request
always in it) is solved again by the plain reference from its instance
and seed, and its best tour and length must be the same, exactly.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from cudabench import trace as tr
from cudabench.reference import aco as ref

WINDOW_STREAM, WARMUP_STREAM = 0, 1


def schedule(seed: int, rate: float, seconds: float, min_n: int, max_n: int,
             box: float, stream: int = WINDOW_STREAM) -> list[dict]:
    """The mix's requests due in [0, seconds): each a dict of ``due`` (s),
    ``n``, ``kind``, ``coords``, ``seed`` (the colony's) and, for a circle,
    ``optimum``."""
    rng = np.random.default_rng([stream, int(seed)])
    k = int(round(rate * seconds))
    if k < 1:
        return []
    q = (np.arange(k) + 0.5) / k
    gaps = rng.permutation(-np.log1p(-q) / rate)
    gaps *= seconds * k / (k + 1) / gaps.sum()
    sizes = rng.permutation(
        min_n + np.floor(q * (max_n - min_n + 1)).astype(np.int64))
    out, t = [], 0.0
    for i in range(k):
        t += float(gaps[i])
        n = int(sizes[i])
        item = {"due": t, "n": n, "seed": (int(seed) << 20) + (stream << 16)
                + i}
        if i % 2 == 0:
            theta = np.sort(rng.uniform(0.0, 2.0 * math.pi, size=n))
            xy = box * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
            closed = np.concatenate([xy, xy[:1]], axis=0)
            item.update(kind="circle", coords=xy, optimum=float(np.sqrt(
                ((closed[1:] - closed[:-1]) ** 2).sum(-1)).sum()))
        else:
            item.update(kind="random", coords=rng.uniform(0.0, box, (n, 2)))
        out.append(item)
    return out


class Session:
    def __init__(self, cell, seed: int, device, seconds: float,
                 trace: bool = False):
        from repro_torch.core import aco, tsp
        from repro_torch.solver.programs import ProgramCache
        from repro_torch.solver.streaming import StreamingSolverService
        conf, mix = cell.config, cell.traffic
        self.tsp = tsp
        self.cfg = aco.ACOConfig(**conf["aco"])
        self.device = torch.device(device)
        self.trace = trace
        self.seed = int(seed)
        self.mix = mix
        svc = conf["service"]
        self.bucket_min = int(svc["min_bucket"])
        self.svc = StreamingSolverService(
            self.cfg, max_batch=int(svc["max_batch"]),
            min_bucket=self.bucket_min, chunk=int(svc["chunk"]),
            patience=int(svc["patience"]), max_waiting=svc["max_waiting"],
            programs=ProgramCache(), device=self.device)
        self.svc.warm_programs(int(mix["min_n"]), int(mix["max_n"]))
        warm = _Replay(self, self._schedule(float(mix["warmup_s"]),
                                            WARMUP_STREAM))
        warm.run(float(mix["warmup_s"]), "cudabench.warmup")
        warm.drain(float(mix["drain_s"]))
        self.items = self._schedule(seconds, WINDOW_STREAM)

    def _schedule(self, seconds: float, stream: int) -> list[dict]:
        mix = self.mix
        return schedule(self.seed, float(mix["rate"]), seconds,
                        int(mix["min_n"]), int(mix["max_n"]),
                        float(mix["box"]), stream)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _submit(self, item: dict) -> int:
        inst = self.tsp.TSPInstance(
            f"{item['kind']}{item['n']}", coords=item["coords"],
            edge_weight_type="RAW", known_optimum=item.get("optimum"))
        return self.svc.submit(inst, iterations=int(self.mix["iterations"]),
                               seed=item["seed"])

    def window(self, seconds: float) -> float:
        """Replay the window's schedule for ``seconds``; returns the
        window's wall seconds."""
        hist = self.svc.tel.registry.histogram("occupancy")
        count, total = hist.count, hist.total
        self.run = _Replay(self, self.items)
        wall = self.run.run(seconds, tr.WINDOW)
        # the exact mean over the window's steps
        self.occupancy = ((hist.total - total) / (hist.count - count)
                          if hist.count > count else None)
        return wall

    def finish(self) -> None:
        """Submit what fell due and step until every request of the window
        has its result or the drain limit has passed."""
        self.run.drain(float(self.mix["drain_s"]))

    def latencies(self) -> list[float]:
        """Each item's due-to-result seconds; one never finished counts
        the whole wait, to the end of the drain."""
        done = self.run.done
        end = self.run.wall if self.run.ended is None else self.run.ended
        return [done[i][0] - it["due"] if i in done else end - it["due"]
                for i, it in enumerate(self.items)]

    def latency(self, q: float) -> float:
        """The q-quantile (nearest rank) of every request's latency."""
        lat = sorted(self.latencies())
        return lat[max(0, math.ceil(q * len(lat)) - 1)]

    def results(self, wall: float) -> dict:
        done = self.run.done
        in_window = sum(1 for t, _ in done.values() if t <= wall)
        return {"attempted": len(self.items),
                "failed": len(self.items) - len(done),
                "metrics": {**{f"latency_p{q}_s": self.latency(q / 100)
                               for q in (50, 90, 95)},
                            "instances_per_s": in_window / wall}}

    def chunk_dispatch_s(self) -> list[float]:
        """Host seconds of each ``chunk_dispatch`` span of the window."""
        tracer = self.svc.tel.tracer
        t0 = tracer.to_us(self.run.t0)
        t1 = t0 + self.run.wall * 1e6
        return [e["dur"] / 1e6 for e in tracer.to_chrome()["traceEvents"]
                if e.get("name") == "chunk_dispatch" and t0 <= e["ts"] <= t1]

    def free(self) -> None:
        """Drop the service and its resident pools and programs."""
        self.svc = None

    # ---------------------------------------------------------- the check
    def check(self) -> dict:
        done = self.run.done
        budget = int(self.mix["iterations"])
        dev = self.device
        iters_off = length_off = 0
        for i, (_, r) in done.items():
            it = self.items[i]
            iters_off += int(r.iterations != budget)
            tour = np.asarray(r.best_tour, dtype=np.int64)
            if not np.array_equal(np.sort(tour), np.arange(it["n"])):
                length_off += 1
                continue
            d = torch.from_numpy(ref.distances(it["coords"], "RAW"))[None]
            t = torch.from_numpy(tour)[None]
            got = ref.tour_lengths(d.to(dev), t.to(dev),
                                   torch.tensor([it["n"]], device=dev))
            length_off += int(float(got[0]) != np.float32(r.best_len))
        out = {"missing": len(self.items) - len(done),
               "iterations_off": iters_off, "length_off": length_off}
        sample = self.sample()
        if sample:
            want = self.solve(sample)
            tour_off = len_off = 0
            for j, i in enumerate(sample):
                r = done[i][1]
                n = self.items[i]["n"]
                tour_off += int(not np.array_equal(
                    np.asarray(r.best_tour, dtype=np.int64),
                    want.best_tour[j, :n].cpu().numpy()))
                len_off += int(np.float32(r.best_len)
                               != np.float32(float(want.best_len[j])))
            out["sample_tour_off"], out["sample_len_off"] = tour_off, len_off
        return {k: (v, 0) for k, v in out.items()}

    def sample(self) -> list[int]:
        """Completed items drawn from the seed, the largest among them."""
        done = sorted(self.run.done)
        k = int(self.mix["check_sample"])
        if not done:
            return []
        largest = max(done, key=lambda i: (self.items[i]["n"], -i))
        rest = [i for i in done if i != largest]
        rng = np.random.default_rng([2, self.seed])
        pick = rng.choice(len(rest), size=min(k - 1, len(rest)),
                          replace=False) if rest else []
        return sorted([largest] + [rest[j] for j in pick])

    def solve(self, idx: list[int], weight_dtype=torch.float32) -> ref.State:
        """The reference's colonies of items ``idx``, stacked in their
        bucket, run for the budget."""
        items = [self.items[i] for i in idx]
        pad = self.bucket_min
        while pad < max(it["n"] for it in items):
            pad <<= 1
        dists = [ref.distances(it["coords"], "RAW") for it in items]
        ants = self.cfg.num_ants(pad)
        col = ref.make_colony(dists, pad, ants, self.device)
        st = ref.initial_state(dists, pad, [it["seed"] for it in items],
                               [it["n"] for it in items], self.device)
        return ref.run(col, st, int(self.mix["iterations"]), self.cfg.q,
                       self.cfg.rho, weight_dtype)


class _Replay:
    """One open-loop replay of ``items`` into a session's service: each
    item submitted when due, the service stepped in between."""

    def __init__(self, session: Session, items: list[dict]):
        self.s, self.items = session, items
        self.rid_of: dict = {}
        self.lag: dict = {}         # item -> due-to-submit seconds
        self.done: dict = {}        # item -> (seconds to result, result)
        self.backlog: list = []     # (seconds, submitted - completed)
        self.next = 0
        self.t0 = self.wall = self.ended = None

    def clock(self) -> float:
        return time.perf_counter() - self.t0

    def submit_due(self, now: float) -> None:
        items = self.items
        while self.next < len(items) and items[self.next]["due"] <= now:
            with tr.annotate("cudabench.submit", self.s.trace):
                rid = self.s._submit(items[self.next])
            self.rid_of[rid] = self.next
            self.lag[self.next] = self.clock() - items[self.next]["due"]
            self.next += 1

    def step(self) -> None:
        with tr.annotate("cudabench.step", self.s.trace):
            got = self.s.svc.step()
        now = self.clock()
        for r in got:
            self.done[self.rid_of[r.request_id]] = (now, r)
        self.backlog.append((now, len(self.rid_of) - len(self.done)))

    def run(self, seconds: float, label: str) -> float:
        """Submit and step for ``seconds``; returns the wall seconds."""
        svc, items = self.s.svc, self.items
        with tr.annotate(label, self.s.trace):
            self.t0 = time.perf_counter()
            while self.clock() < seconds:
                self.submit_due(self.clock())
                if svc.busy:
                    self.step()
                else:
                    wake = items[self.next]["due"] \
                        if self.next < len(items) else seconds
                    with tr.annotate("cudabench.idle", self.s.trace):
                        time.sleep(max(0.0, min(wake, seconds)
                                       - self.clock()))
            self.wall = self.clock()
        return self.wall

    def drain(self, seconds: float) -> None:
        self.submit_due(float("inf"))
        while self.s.svc.busy and len(self.done) < len(self.items) and \
                self.clock() < self.wall + seconds:
            self.step()
        self.s._sync()
        self.ended = self.clock()
