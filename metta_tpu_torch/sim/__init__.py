"""Evaluation of the port: rollouts, simulations, replays.

``single_episode.py``, ``serve_policy.py`` and ``remote.py`` of
``metta_tpu/sim`` are not ported: they need a port-owned copy of the
generated ``metta_tpu/protobuf/sim_gen`` modules.
"""

from metta_tpu_torch.sim.grid_objects import grid_objects
from metta_tpu_torch.sim.replay_writer import EpisodeReplay, ReplayLogWriter
from metta_tpu_torch.sim.rollout import (
    MultiEpisodeRolloutResult,
    compute_policy_agent_counts,
    multi_episode_rollout,
)
from metta_tpu_torch.sim.runner import SimulationConfig, SimulationResult, run_simulations

__all__ = [
    "EpisodeReplay", "MultiEpisodeRolloutResult", "ReplayLogWriter",
    "SimulationConfig", "SimulationResult", "compute_policy_agent_counts",
    "grid_objects", "multi_episode_rollout", "run_simulations",
]

# what the unported modules define, each refused by name
_UNPORTED = {
    **dict.fromkeys(("load_policy_for_env", "run_single_episode_job", "job_from_config"),
                    "metta_tpu/sim/single_episode.py"),
    **dict.fromkeys(("PolicyService", "create_server", "PolicyClient", "game_rules_from_env"),
                    "metta_tpu/sim/serve_policy.py"),
    **dict.fromkeys(("EvalTask", "EvalTaskQueue", "evaluate_remotely", "run_eval_worker"),
                    "metta_tpu/sim/remote.py"),
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{name} ({_UNPORTED[name]}) is not ported: it needs a port-owned copy of the "
            f"generated metta_tpu/protobuf/sim_gen modules")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
