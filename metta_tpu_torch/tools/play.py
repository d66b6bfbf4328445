"""PlayTool and ReplayTool.

Counterpart of ``metta_tpu/tools/play.py`` (reference
``metta/tools/play.py``, ``replay.py``). Play steps one env (E=1, the
sequential step) with a policy, or random actions, and renders each step in
the terminal through the miniscope renderer; Replay runs episodes in the
batched step and writes mettascope-compatible ``.json.z`` replays. Both run
on the tool's device, the card unless ``device=cpu``. ``serve=True`` (browser
live play) needs ``metta_tpu/renderer/live_server.py``, which is not ported:
it is refused before anything is built.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.compiler import compile_config
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.policy.policy import NetworkPolicy, RandomPolicy
from metta_tpu_torch.renderer import LIVE_SERVER
from metta_tpu_torch.renderer.miniscope import MiniscopeRenderer
from metta_tpu_torch.sim.rollout import multi_episode_rollout
from metta_tpu_torch.tools.tool import Tool

logger = logging.getLogger(__name__)


class PlayTool(Tool):
    env: Optional[MettaGridConfig] = None
    policy_uri: Optional[str] = None
    steps: int = 100
    fps: float = 5.0
    seed: int = 0
    interactive: bool = False  # raw-tty miniscope (pause/camera/manual control)
    serve: bool = False        # browser live play (WebSocket mettascope server): not ported
    port: int = 8070

    def invoke(self) -> int:
        if self.serve:
            raise NotImplementedError(f"PlayTool(serve=True) needs {LIVE_SERVER}, which is "
                                      f"not ported")
        device = self._apply_device()
        if self.env is None:
            self.env = make_navigation(num_agents=2, width=12, height=12)
        env = MettaGridEnv(self.env, num_envs=1, seed=self.seed, desync_episodes=False,
                           device=device)
        A = env.num_agents
        if self.policy_uri:
            policy = NetworkPolicy.from_bundle(self.policy_uri, env.compiled, n_slots=A,
                                               device=device)
        else:
            policy = RandomPolicy(env.compiled.n_actions, seed=self.seed)
        renderer = MiniscopeRenderer(env)
        if self.interactive and sys.stdin.isatty():
            renderer.interactive_loop(policy, max_steps=self.steps)
            return 0
        obs = env.reset()
        for _ in range(self.steps):
            actions = policy.step_batch(obs[0]).reshape(1, A)
            obs, rew, done, trunc = env.step(actions)
            renderer.render()
            time.sleep(1.0 / self.fps)
        return 0


class ReplayTool(Tool):
    env: Optional[MettaGridConfig] = None
    policy_uri: Optional[str] = None
    episodes: int = 1
    replay_dir: str = "./replays"
    seed: int = 0

    def invoke(self) -> int:
        device = self._apply_device()
        if self.env is None:
            self.env = make_navigation(num_agents=2, width=12, height=12)
        compiled = compile_config(self.env)
        if self.policy_uri:
            policy = NetworkPolicy.from_bundle(self.policy_uri, compiled,
                                               n_slots=self.episodes * compiled.num_agents,
                                               device=device)
        else:
            policy = RandomPolicy(compiled.n_actions, seed=self.seed)
        result = multi_episode_rollout(
            self.env, [policy], episodes=self.episodes, seed=self.seed,
            save_replay=self.replay_dir, device=device,
        )
        for ep in result.episodes:
            if ep.replay_path:
                logger.info("replay: %s", ep.replay_path)
        return 0
