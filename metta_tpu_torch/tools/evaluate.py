"""EvaluateTool: a policy bundle through a suite of simulations.

Counterpart of ``metta_tpu/tools/evaluate.py`` (reference
``metta/tools/eval.py``). The simulations run on the tool's device (the card
unless ``device=cpu``), in the batched step, as in the JAX tool.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Optional

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.compiler import compile_config
from metta_tpu_torch.policy.policy import NetworkPolicy
from metta_tpu_torch.sim.runner import SimulationConfig, run_simulations
from metta_tpu_torch.tools.tool import Tool

logger = logging.getLogger(__name__)


class EvaluateTool(Tool):
    policy_uri: str
    env: Optional[MettaGridConfig] = None
    episodes: int = 8
    seed: int = 0
    replay_dir: Optional[str] = None
    output_json: Optional[str] = None

    _simulations: Any = None

    def with_simulations(self, sims) -> "EvaluateTool":
        object.__setattr__(self, "_simulations", sims)
        return self

    def invoke(self) -> int:
        device = self._apply_device()
        sims = self._simulations
        if sims is None:
            if self.env is None:
                raise SystemExit("EvaluateTool needs env= or simulations")
            sims = [SimulationConfig(suite="eval", name="default", env=self.env,
                                     episodes=self.episodes)]

        policy = NetworkPolicy.from_bundle(self.policy_uri, compile_config(sims[0].env),
                                           n_slots=1, device=device)
        results = run_simulations([policy], sims, seed=self.seed,
                                  replay_dir=self.replay_dir, device=device)
        payload = []
        for r in results:
            logger.info("%s: mean_reward %.4f", r.key, r.mean_reward)
            payload.append({
                "suite": r.suite, "name": r.name, "mean_reward": r.mean_reward,
                "mean_stats": r.mean_stats,
            })
        if self.output_json:
            with open(self.output_json, "w") as f:
                json.dump(payload, f, indent=2)
        return 0
