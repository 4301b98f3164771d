"""ray_tpu_torch.rl: reinforcement learning on learner actors that hold
the card (the port of ray_tpu/rl).

The new-API-stack shape: Algorithm / Learner / LearnerGroup / RLModule /
EnvRunner. Modules are `nn.Module`s whose weights cross actors as the
JAX package's numpy trees; env runners sample on the CPU; learners
compute on the card unless the caller asks for the CPU, and several
learners sync gradients over the DCN group.

This slice holds PPO and A2C, IMPALA, APPO and the DQN family. SAC,
TD3/DDPG, CQL, R2D2, recurrent PPO, Ape-X, multi-agent and offline RL
are ROADMAP item A7b: their names raise NotImplementedError here.
"""

from ray_tpu_torch._private.not_ported import not_ported
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig, appo_loss
from ray_tpu_torch.rl.algorithms.dqn import (
    DQN,
    DQNConfig,
    c51_loss,
    categorical_projection,
    dqn_loss,
    noisy_dqn_loss,
)
from ray_tpu_torch.rl.algorithms.impala import (
    IMPALA,
    IMPALAConfig,
    impala_loss,
    vtrace,
)
from ray_tpu_torch.rl.algorithms.ppo import (
    A2CConfig,
    PPO,
    PPOConfig,
    a2c_loss,
    ppo_loss,
)
from ray_tpu_torch.rl.connectors import (
    ClipReward,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    NormalizeObs,
)
from ray_tpu_torch.rl.core.learner import Learner
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import (
    C51QNetworkModule,
    ContinuousModuleSpec,
    ContinuousPolicyModule,
    ConvModuleSpec,
    ConvPolicyModule,
    ConvQNetworkModule,
    DiscretePolicyModule,
    DuelingQNetworkModule,
    NoisyQNetworkModule,
    RecurrentModuleSpec,
    RecurrentPolicyModule,
    RecurrentQNetworkModule,
    RLModuleSpec,
)
from ray_tpu_torch.rl.env_runner import (
    ContinuousTransitionRunner,
    EnvRunner,
    TransitionEnvRunner,
    VectorEnvRunner,
    compute_gae,
)
from ray_tpu_torch.rl.replay import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    n_step_transitions,
)

# The JAX package's names that the next slice (ROADMAP A7b) ports.
A7B_NAMES = frozenset({
    "SAC", "SACConfig", "TD3", "TD3Config", "DDPGConfig", "CQL", "CQLConfig",
    "R2D2", "R2D2Config", "RecurrentPPO", "RecurrentPPOConfig",
    "recurrent_ppo_loss", "APEX", "APEXConfig", "ReplayShardActor",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "MultiRLModule", "BC", "BCConfig", "MARWIL",
    "MARWILConfig", "bc_loss", "episodes_to_dataset", "dataset_to_batch",
})


def __getattr__(name):
    if name in A7B_NAMES:
        raise not_ported(f"ray_tpu_torch.rl.{name}", "A7b")
    raise AttributeError(f"module 'ray_tpu_torch.rl' has no attribute {name!r}")


__all__ = [
    "ContinuousModuleSpec",
    "ContinuousPolicyModule",
    "ContinuousTransitionRunner",
    "APPO",
    "APPOConfig",
    "appo_loss",
    "VectorEnvRunner",
    "Learner",
    "LearnerGroup",
    "RLModuleSpec",
    "ConvModuleSpec",
    "ConvPolicyModule",
    "ConvQNetworkModule",
    "DiscretePolicyModule",
    "RecurrentModuleSpec",
    "RecurrentPolicyModule",
    "RecurrentQNetworkModule",
    "DuelingQNetworkModule",
    "EnvRunner",
    "compute_gae",
    "DQN",
    "DQNConfig",
    "dqn_loss",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
    "n_step_transitions",
    "TransitionEnvRunner",
    "PPO",
    "PPOConfig",
    "ppo_loss",
    "A2CConfig",
    "a2c_loss",
    "c51_loss",
    "categorical_projection",
    "C51QNetworkModule",
    "NoisyQNetworkModule",
    "noisy_dqn_loss",
    "IMPALA",
    "IMPALAConfig",
    "impala_loss",
    "vtrace",
    "Connector",
    "ConnectorPipeline",
    "FlattenObs",
    "NormalizeObs",
    "ClipReward",
]
