"""joblib backend: run scikit-learn style `Parallel` work on the cluster.

Analog of the reference's ``ray.util.joblib`` (register_ray +
ray_backend.py): registers an "rt" backend so

    from ray_tpu_torch.util.joblib import register_rt
    register_rt()
    with joblib.parallel_backend("rt"):
        Parallel(n_jobs=8)(delayed(f)(i) for i in range(100))

executes batches as cluster tasks.
"""

from __future__ import annotations

from joblib._parallel_backends import ParallelBackendBase
from joblib.parallel import register_parallel_backend

import ray_tpu_torch as rt


@rt.remote
def _run_batch(batch):
    return batch()


class RTBackend(ParallelBackendBase):
    """Dispatch joblib batches as ray_tpu tasks."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  **kwargs):
        if not rt.is_initialized():
            rt.init()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs):
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 is not a valid specification")
        if n_jobs < 0:
            # Cluster-wide CPU count plays the role of cpu_count().
            try:
                from ray_tpu_torch.util.state import list_nodes

                total = sum(
                    int(n["resources_total"].get("CPU", 0))
                    for n in list_nodes()
                    if n["state"] == "ALIVE"
                )
                return max(1, total)
            except Exception:
                return 4
        return n_jobs

    def apply_async(self, func, callback=None):
        ref = _run_batch.remote(func)
        return _RTFuture(ref, callback)

    # joblib >= 1.3 calls submit(); apply_async remains the legacy alias.
    def submit(self, func, callback=None):
        return self.apply_async(func, callback)

    def abort_everything(self, ensure_ready=True):
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs, parallel=self.parallel)


class _RTFuture:
    def __init__(self, ref, callback):
        self._ref = ref
        self._callback = callback
        if callback is not None:
            import threading

            def waiter():
                try:
                    result = rt.get(ref)
                except Exception:
                    return
                callback(result)

            threading.Thread(target=waiter, daemon=True).start()

    def get(self, timeout=None):
        return rt.get(self._ref, timeout=timeout)


def register_rt():
    register_parallel_backend("rt", RTBackend)
