"""Runtime environments (the port of ray_tpu/runtime_env/)."""

from ray_tpu_torch.runtime_env.runtime_env import (  # noqa: F401
    RuntimeEnv,
    apply_runtime_env,
    prepare_runtime_env,
)
