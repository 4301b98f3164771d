"""The autoscaler of the PyTorch port: providers, the v1 loop, the v2
instance manager and the cluster launcher behind `rt up/down/exec/attach`.
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler  # noqa: F401
from ray_tpu_torch.autoscaler.launcher import ClusterLauncher  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    FakeMultiNodeProvider,
    GCETPUNodeProvider,
    GKETPUNodeProvider,
    NodeProvider,
    ProcessNodeProvider,
    make_node_provider,
)
from ray_tpu_torch.autoscaler.v2 import (  # noqa: F401
    Instance,
    InstanceManager,
    Monitor,
    Reconciler,
    Scheduler,
)
