"""Traffic from a mix's parameters and the run's seed.

Every seed gets the same set of sizes and arrival gaps, drawn once from
the mix's own `schedule_seed`, in an order that the run's seed permutes;
the token ids come from the run's seed. So two seeds offer the same work,
and differ only in which request comes when and in what it says.

The draws are frozen copies of the program's load generator, which is
sound (pure functions of spec and seed): `lognormal_length` is
`LengthMix.draw` without the tail bucket (`ray_tpu_torch/loadgen/
workload.py:117-122`), and `poisson_gaps` is the homogeneous case of
`open_loop_arrivals` (`ray_tpu_torch/loadgen/arrival.py:53-63`).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch


def lognormal_length(rng: random.Random, median: int, sigma: float, lo: int,
                     hi: int) -> int:
    n = int(round(rng.lognormvariate(math.log(median), sigma)))
    return min(max(n, lo), hi)


def poisson_gaps(rng: random.Random, rate: float, span_s: float) -> List[float]:
    """Inter-arrival gaps of a Poisson process at `rate` while their sum
    stays below span_s."""
    gaps, t = [], 0.0
    while True:
        g = rng.expovariate(rate)
        if t + g >= span_s:
            return gaps
        gaps.append(g)
        t += g


def chat_requests(mix: Dict, seconds: float, seed: int, vocab: int) -> Dict:
    """The serve mix's schedule for a window of `seconds`: system prompts
    and requests (due time, system prompt, prompt ids, max_new_tokens)."""
    fixed = random.Random(int(mix["schedule_seed"]))
    arr = mix["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    gaps = poisson_gaps(fixed, float(arr["rate_per_s"]), float(seconds))
    n = len(gaps)
    sysp, user, out = mix["system_prompts"], mix["user_tokens"], \
        mix["output_tokens"]
    sizes = [(fixed.randrange(int(sysp["count"])),
              lognormal_length(fixed, user["median"], user["sigma"],
                               user["lo"], user["hi"]),
              lognormal_length(fixed, out["median"], out["sigma"],
                               out["lo"], out["hi"]))
             for _ in range(n)]
    order = random.Random(int(seed))
    order.shuffle(gaps)
    order.shuffle(sizes)
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    systems = torch.randint(0, vocab, (int(sysp["count"]), int(sysp["tokens"])),
                            generator=gen).tolist()
    requests, t = [], 0.0
    for g, (s, u, o) in zip(gaps, sizes):
        t += g
        ids = torch.randint(0, vocab, (u,), generator=gen).tolist()
        requests.append({"due": t, "system": s, "prompt": systems[s] + ids,
                         "max_new_tokens": o})
    return {"systems": systems, "requests": requests}


def train_batches(gen: torch.Generator, n: int, batch: int, seq: int,
                  vocab: int, device) -> torch.Tensor:
    """n batches of [batch, seq + 1] token ids, uniform over the
    vocabulary (inputs and their next-token labels)."""
    return torch.randint(0, vocab, (n, batch, seq + 1), generator=gen,
                         device=device)
