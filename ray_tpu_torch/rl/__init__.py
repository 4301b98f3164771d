"""ray_tpu_torch.rl: reinforcement learning on learner actors that hold
the card (the port of ray_tpu/rl).

The new-API-stack shape: Algorithm / Learner / LearnerGroup / RLModule /
EnvRunner. Modules are `nn.Module`s whose weights cross actors as the
JAX package's numpy trees; env runners sample on the CPU; learners, and
the updates that SAC, TD3, CQL and R2D2 run in the driver, compute on
the card unless the caller asks for the CPU, and several learners sync
gradients over the DCN group.
"""

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

from ray_tpu_torch.rl.algorithms.apex import APEX, APEXConfig, ReplayShardActor
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rl.algorithms.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rl.algorithms.recurrent_ppo import (
    RecurrentPPO,
    RecurrentPPOConfig,
    recurrent_ppo_loss,
)
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rl.algorithms.td3 import DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiRLModule,
)
from ray_tpu_torch.rl.offline import (
    BC,
    BCConfig,
    MARWIL,
    MARWILConfig,
    bc_loss,
    dataset_to_batch,
    episodes_to_dataset,
)

__all__ = [
    "SAC",
    "SACConfig",
    "TD3",
    "TD3Config",
    "CQL",
    "CQLConfig",
    "APEX",
    "APEXConfig",
    "ReplayShardActor",
    "DDPGConfig",
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
    "RecurrentPPO",
    "RecurrentPPOConfig",
    "R2D2",
    "R2D2Config",
    "recurrent_ppo_loss",
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
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiRLModule",
    "Connector",
    "ConnectorPipeline",
    "FlattenObs",
    "NormalizeObs",
    "ClipReward",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "bc_loss",
    "episodes_to_dataset",
    "dataset_to_batch",
]
