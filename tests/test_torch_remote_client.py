"""The port's remote (rt://) driver, `ray_tpu_torch/__init__.py`
`_remote_attach`: the case of tests/test_remote_client.py run against
ray_tpu_torch. A driver with no local node and no shared memory drives a
`Cluster` of the port entirely over TCP: a task, a 8 MB put and get
(chunked), a large task return, an actor. The driver runs in a
subprocess, so it cannot share memory with the cluster's store.
"""

import subprocess
import sys
import textwrap

from ray_tpu_torch.cluster_utils import Cluster


_DRIVER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import ray_tpu_torch as rt

    rt.init(address="rt://" + sys.argv[1])

    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(2, 3), timeout=60) == 5

    # Large object round trip through the raylet proxy (no local shm).
    # > object_transfer_chunk_size (5MB): exercises chunked put
    arr = np.arange(1_000_000, dtype=np.float64)
    ref = rt.put(arr)
    out = rt.get(ref, timeout=60)
    assert out.sum() == arr.sum()

    # Large TASK RETURN fetched remotely.
    @rt.remote
    def big():
        return np.ones(400_000)

    assert rt.get(big.remote(), timeout=60).sum() == 400_000.0

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0
        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert rt.get(c.inc.remote(), timeout=60) == 1
    assert rt.get(c.inc.remote(), timeout=60) == 2

    rt.shutdown()
    print("REMOTE DRIVER OK")
    """
)

import os


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_remote_driver_over_tcp(tmp_path):
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        script = tmp_path / "remote_driver.py"
        script.write_text(_DRIVER.format(repo=_REPO))
        p = subprocess.run(
            [sys.executable, str(script), f"127.0.0.1:{cluster.gcs_port}"],
            capture_output=True, timeout=240, text=True,
        )
        assert p.returncode == 0, (
            f"remote driver failed rc={p.returncode}\n"
            f"stdout: {p.stdout}\nstderr: {p.stderr[-3000:]}"
        )
        assert "REMOTE DRIVER OK" in p.stdout
    finally:
        cluster.shutdown()
