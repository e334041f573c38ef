"""HERO core: the paper's contribution.

- ddpg:      deep deterministic policy gradient agent (PyTorch actor/critic)
- action:    continuous action -> bit width mapping (Eq. 3)
- reward:    hardware-aware reward (Eqs. 8-9)
- env:       NGP quantization environment (observation Eqs. 1-2, episode
             walk, constraint enforcement, finetune + PSNR + simulator)
- batched_env: population evaluation — K policies per step through the
             batched simulator + PSNR proxy
- search:    the episodic HERO search loop + population mode (CEM + DDPG)
- pareto:    constraint sets + dominated-policy pruning + frontier tracking
             (latency / PSNR / model size) with exact hypervolume
- closed_loop: HeroSearchRun — the multi-scene x multi-budget closed loop
             (shared scene bundles, cell-granular checkpoint/resume of the
             frontier in the JAX package's schema v2)
- baselines: PTQ / QAT / CAQ-proxy comparison methods

The loop is workload-generic: `repro_torch.workloads` supplies the
per-case bundles (the `nerf` scene adapter and the `lm` quantization
workload).
"""
from repro_torch.core.action import action_to_bits, bits_to_action
from repro_torch.core.ddpg import DDPGAgent, DDPGConfig, ReplayBuffer
from repro_torch.core.reward import hero_reward, cost_ratio
from repro_torch.core.env import NGPQuantEnv, EnvConfig, EpisodeResult
from repro_torch.core.batched_env import (
    BatchedEnvConfig,
    BatchedQuantEnv,
    PopulationEval,
)
from repro_torch.core.search import (
    hero_search,
    hero_population_search,
    SearchConfig,
    SearchResult,
    PopulationSearchConfig,
    PopulationSearchResult,
)
from repro_torch.core.baselines import (
    ptq_baseline,
    qat_baseline,
    caq_proxy_baseline,
    BaselineResult,
)
from repro_torch.core.pareto import (
    ConstraintSet,
    ParetoFrontier,
    ParetoPoint,
    pareto_filter,
)
from repro_torch.core.closed_loop import (
    ClosedLoopConfig,
    ClosedLoopResult,
    HeroSearchRun,
    SceneBundle,
    SceneScale,
    build_scene_bundle,
    build_scene_env,
)

__all__ = [
    "action_to_bits",
    "bits_to_action",
    "DDPGAgent",
    "DDPGConfig",
    "ReplayBuffer",
    "hero_reward",
    "cost_ratio",
    "NGPQuantEnv",
    "EnvConfig",
    "EpisodeResult",
    "BatchedEnvConfig",
    "BatchedQuantEnv",
    "PopulationEval",
    "hero_search",
    "hero_population_search",
    "SearchConfig",
    "SearchResult",
    "PopulationSearchConfig",
    "PopulationSearchResult",
    "ptq_baseline",
    "qat_baseline",
    "caq_proxy_baseline",
    "BaselineResult",
    "ConstraintSet",
    "ParetoFrontier",
    "ParetoPoint",
    "pareto_filter",
    "ClosedLoopConfig",
    "ClosedLoopResult",
    "HeroSearchRun",
    "SceneBundle",
    "SceneScale",
    "build_scene_bundle",
    "build_scene_env",
]
