from ray_tpu_torch.dag.dag_node import (  # noqa: F401
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG  # noqa: F401
