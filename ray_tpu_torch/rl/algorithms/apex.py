"""APEX-DQN: distributed prioritized experience replay (Horgan et al.
2018; the port of ray_tpu/rl/algorithms/apex.py).

Reference analog: rllib/algorithms/apex_dqn — DQN scaled out by (a) many
env runners with a fixed per-runner exploration ladder
(eps_i = base ** (1 + 7 i/(N-1)), so some runners always explore hard
while others exploit), (b) the replay buffer sharded across dedicated
REPLAY ACTORS so insertion/sampling never contends with the driver, and
(c) asynchronous collection: runners sample continuously and the driver
routes whichever rollouts finish first to a shard (rt.wait), instead of
barriering on all runners each iteration.

The TD-update math (double-Q, n-step discounts, C51 projection, PER
weights) is inherited from the port's DQN unchanged, with its learner
and target net on the config's device; the shards and the runners are
CPU actors. Only the replay plumbing is swapped via the buffer interface
hooks (_collect/_sample_minibatch/_update_priorities/_buffer_size).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.replay import PrioritizedReplayBuffer


@rt.remote
class ReplayShardActor:
    """One shard of the distributed prioritized replay (reference: the
    ReplayActor rllib creates per apex replay shard)."""

    def __init__(self, capacity: int, obs_dim: int, seed: int, alpha: float):
        self.buf = PrioritizedReplayBuffer(
            capacity, obs_dim, seed=seed, alpha=alpha, store_discounts=True
        )

    def add_batch(self, batch) -> int:
        self.buf.add_batch(batch)
        return len(self.buf)

    def sample(self, n: int, beta: float):
        if len(self.buf) < n:
            return None
        return self.buf.sample(n, beta=beta)

    def update_priorities(self, indices, td_abs) -> bool:
        self.buf.update_priorities(np.asarray(indices), np.asarray(td_abs))
        return True

    def size(self) -> int:
        return len(self.buf)


@dataclass
class APEXConfig(DQNConfig):
    """APEX defaults: prioritized replay on, more runners, sharded buffer
    (reference: ApexDQNConfig)."""

    num_env_runners: int = 4
    num_replay_shards: int = 2
    prioritized_replay: bool = True
    # Exploration ladder base (Horgan et al.: eps_i = base^(1 + 7i/(N-1))).
    apex_eps_base: float = 0.4

    def build(self) -> "APEX":
        return APEX(self)


class APEX(DQN):
    def _make_buffer(self):
        # Replay lives in the shard actors; no driver-side buffer (avoids
        # a capacity-sized allocation that would be discarded).
        return None

    def __init__(self, config: APEXConfig):
        super().__init__(config)
        self.shards = [
            ReplayShardActor.options(num_cpus=0.1).remote(
                max(1, config.buffer_capacity // config.num_replay_shards),
                config.obs_shape if config.obs_shape is not None
                else config.obs_dim,
                config.seed + 1000 + i,
                config.per_alpha,
            )
            for i in range(config.num_replay_shards)
        ]
        n = config.num_env_runners
        self._runner_eps = [
            config.apex_eps_base ** (1 + 7 * i / max(n - 1, 1))
            for i in range(n)
        ]
        # Async collection state: one outstanding sample() per runner.
        self._pending = {
            r.sample.remote(self._runner_eps[i]): (r, i)
            for i, r in enumerate(self.env_runners)
        }
        self._shard_sizes = [0] * config.num_replay_shards
        self._next_shard = 0
        self._rng = np.random.default_rng(config.seed + 7)
        # Pipelined episode-stats probes + last-known stats per runner
        # (train() never barriers on a rollout to read stats).
        self._stats_refs: Dict[int, object] = {}
        self._stats_cache: Dict[int, dict] = {}
        # Leash for fire-and-forget calls: refs are kept (so the store
        # can release results and errors are observable) and reaped
        # non-blockingly once enough accumulate.
        self._async_refs: list = []

    def _track_async(self, ref):
        """Track a fire-and-forget ref without blocking the train loop.
        Dropping the ref outright would leak the result in the object
        store and swallow any error; a zero-timeout reap keeps both
        bounded while preserving the async design."""
        self._async_refs.append(ref)
        if len(self._async_refs) < 64:
            return
        ready, pending = rt.wait(
            self._async_refs, num_returns=len(self._async_refs), timeout=0
        )
        for r in ready:
            try:
                rt.get(r, timeout=1)
            except Exception:  # noqa: BLE001
                # Best-effort op (priority refresh / weight push) failed;
                # apex tolerates staleness, the next push retries.
                pass
        self._async_refs = list(pending)

    # -- buffer interface over the shard actors ---------------------------
    def _collect(self, eps: float):
        """Route whichever rollouts have finished to shards round-robin
        and immediately resubmit those runners; never barriers on the
        slowest runner (the iteration's epsilon argument is ignored —
        each runner keeps its ladder epsilon)."""
        # Invariant: every pop below resubmits, so one sample() per
        # runner is always outstanding.
        ready, _ = rt.wait(
            list(self._pending), num_returns=1, timeout=60.0
        )
        if not ready:
            return
        done = list(ready)
        rest = [r for r in self._pending if r not in set(done)]
        if rest:
            # Drain everything already finished, not just the first.
            more, _ = rt.wait(rest, num_returns=len(rest), timeout=0.0)
            done.extend(more)
        adds = []
        for ref in done:
            runner, idx = self._pending.pop(ref)
            try:
                batch = rt.get(ref, timeout=60)
            except Exception:  # noqa: BLE001 — runner died: resubmit
                # anyway so a restarted actor (max_restarts) rejoins the
                # pool; a permanently-dead one just errors again next
                # tick (bounded: one failed ref per collect pass).
                self._pending[
                    runner.sample.remote(self._runner_eps[idx])
                ] = (runner, idx)
                continue
            shard = self._next_shard % len(self.shards)
            self._next_shard += 1
            adds.append((shard, self.shards[shard].add_batch.remote(batch)))
            # Queue the stats probe BEFORE the next rollout so it runs
            # right away on the serial actor instead of waiting a full
            # rollout; train() reads whichever probes resolved.
            self._stats_refs[idx] = runner.episode_stats.remote()
            self._pending[
                runner.sample.remote(self._runner_eps[idx])
            ] = (runner, idx)
        for shard, ref in adds:
            try:
                self._shard_sizes[shard] = rt.get(ref, timeout=60)
            except Exception:  # noqa: BLE001
                pass

    def _buffer_size(self) -> int:
        return int(sum(self._shard_sizes))

    def _sample_minibatch(self, beta: float):
        shard = int(self._rng.integers(len(self.shards)))
        mb = rt.get(
            self.shards[shard].sample.remote(
                self.config.train_batch_size, beta
            ),
            timeout=60,
        )
        if mb is not None:
            mb["_shard"] = shard
        return mb

    def _update_priorities(self, mb, td_abs: np.ndarray):
        # Fire-and-forget: priority freshness is best-effort in apex.
        self._track_async(
            self.shards[mb["_shard"]].update_priorities.remote(
                mb["indices"], td_abs
            )
        )

    def _episode_stats(self):
        """Non-blocking: harvest whichever pipelined stats probes
        resolved; runners mid-rollout report their last-known stats."""
        refs = list(self._stats_refs.items())
        if refs:
            ready, _ = rt.wait(
                [r for _, r in refs], num_returns=len(refs), timeout=1.0
            )
            ready_set = set(ready)
            for idx, ref in refs:
                if ref in ready_set:
                    try:
                        self._stats_cache[idx] = rt.get(ref, timeout=30)
                    except Exception:  # noqa: BLE001 — runner died
                        pass
                    self._stats_refs.pop(idx, None)
        return list(self._stats_cache.values()) or [
            {"episodes": 0, "mean_return": 0.0}
        ]

    def _report_epsilon(self, eps: float):
        # Fixed per-runner ladder, not the DQN decay schedule.
        return [round(e, 4) for e in self._runner_eps]

    def _broadcast_weights(self, weights=None):
        """Fire-and-forget: the new weights queue behind each runner's
        in-flight rollout and apply to its NEXT one (apex's async weight
        update), without train() blocking on the slowest runner."""
        if not hasattr(self, "_runner_eps"):
            # Called from DQN.__init__ before apex state exists: the
            # blocking broadcast is fine there (no rollouts in flight).
            return super()._broadcast_weights(weights)
        if weights is None:
            weights = self.learner_group.get_weights()
        for r in self.env_runners:
            self._track_async(r.set_weights.remote(weights))

    # Note: shard CONTENTS are not checkpointed (fresh shard actors start
    # empty on restore), so _shard_sizes deliberately restarts at 0 — the
    # learning_starts warmup gate re-applies after a restore, exactly as
    # the reference's apex restore refills its replay actors.

    def stop(self):
        super().stop()
        for s in self.shards:
            try:
                rt.kill(s)
            except Exception:  # noqa: BLE001
                pass
