"""The one traffic generator: open-loop arrivals for a unit's engines
from a traffic file's parameters.

The lengths are the lognormal of the port's ``core/workload.py``
(``sharegpt_lengths``: mu = log(mean) - sigma^2 / 2, clipped), the
arrival gaps exponential as in its ``poisson_trace``, and the split
between the engines the paper's power law ``rate_i ~ (i + 1)^-alpha``
(``power_law_rates``), frozen here so that a change to the program
cannot change the traffic.

A run's seed does not change the work, only its order: the traffic
file's ``base_seed`` draws the arrival times and one fixed multiset of
lengths and engine assignments for the fill period and one for the
window; the run's seed deals the lengths and engines out over the
arrivals in another order, within each run of ``BLOCK`` consecutive
arrivals, and draws the prompts' token ids.  Every seed therefore sends
the same requests at the same instants, the same number of them due in
the window, and the same work in each stretch of a few seconds: the
seed moves which request meets which burst, not how much work a burst
brings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

# arrivals dealt among themselves by the run's seed
BLOCK = 8


@dataclass
class Arrival:
    """One request as the generator makes it: ``due`` in seconds from
    the start of the fill period, ``window`` whether it is due inside
    the measured window."""
    req_id: int
    engine: str
    due: float
    prompt: List[int] = field(repr=False)
    max_new: int
    window: bool


def power_law_shares(n: int, alpha: float) -> np.ndarray:
    raw = np.array([(i + 1.0) ** (-alpha) for i in range(n)])
    return raw / raw.sum()


def lognormal_lengths(rng: np.random.Generator, n: int, spec: dict
                      ) -> np.ndarray:
    mu = math.log(spec["mean"]) - spec["sigma"] ** 2 / 2
    return np.clip(rng.lognormal(mu, spec["sigma"], n).astype(int),
                   spec["min"], spec["max"])


def _segment(base: np.random.Generator, rng: np.random.Generator,
             n: int, span: float, engines: Sequence[str],
             shares: np.ndarray, traffic: dict):
    """``n`` arrivals over ``span`` seconds: the arrival times, lengths
    and engines drawn from ``base`` (fixed), the order in which the
    lengths and engines meet the arrivals from ``rng``."""
    gaps = base.exponential(1.0, n + 1)
    gaps *= span / gaps.sum()
    due = np.cumsum(gaps)[:n]
    prompts = lognormal_lengths(base, n, traffic["prompt"])
    outputs = lognormal_lengths(base, n, traffic["output"])
    counts = np.floor(shares * n).astype(int)
    counts[0] += n - counts.sum()
    who = np.repeat(np.arange(len(engines)), counts)
    who = base.permutation(who)
    order = np.concatenate([a + rng.permutation(min(BLOCK, n - a))
                            for a in range(0, n, BLOCK)])
    return due, prompts[order], outputs[order], who[order]


def make_arrivals(traffic: dict, engines: Sequence[str],
                  vocab: Dict[str, int], envelope: int, seed: int,
                  seconds: float) -> List[Arrival]:
    """The fill period's and the window's arrivals, sorted by due time.

    ``traffic``: a traffic file (``rate`` in requests/s over all
    engines, ``alpha``, ``fill_s``, ``base_seed``, ``prompt`` and
    ``output`` length specs); ``engines`` in popularity order;
    ``vocab`` the vocabulary of each engine; ``envelope`` the tokens a
    sequence may hold (prompt + output + the reserved next token fit
    in it, as the port's ``requests_from_workload`` clips them)."""
    base = np.random.default_rng(int(traffic["base_seed"]))
    rng = np.random.default_rng(seed)
    shares = power_law_shares(len(engines), float(traffic["alpha"]))
    rate, fill = float(traffic["rate"]), float(traffic["fill_s"])
    out: List[Arrival] = []
    for start, span, in_window in ((0.0, fill, False),
                                   (fill, float(seconds), True)):
        n = int(round(rate * span))
        if n == 0:
            continue
        due, plens, olens, who = _segment(base, rng, n, span, engines,
                                          shares, traffic)
        for t, p, o, e in zip(due, plens, olens, who):
            name = engines[e]
            o = max(1, min(int(o), envelope // 2))
            p = max(1, min(int(p), envelope - o - 1))
            prompt = rng.integers(1, vocab[name], p).tolist()
            out.append(Arrival(len(out), name, start + float(t), prompt, o,
                               in_window))
    out.sort(key=lambda a: a.due)
    return out
