"""TrainTool: the end-to-end training entry point.

Counterpart of ``metta_tpu/tools/train.py`` (reference
``metta/tools/train.py:65-482``): composes the env (or a curriculum over
envs), the policy, the trainer, the checkpointer and progress logging. The
reference's component callbacks (Checkpointer every 30 epochs, ProgressLogger
SPS lines, Heartbeat) are in-lined into the update loop; one update = one
train batch (rollout + PPO).

The evaluator (``evaluate_interval`` > 0, with ``with_simulations``) saves
a bundle and runs the simulations on it through ``sim/runner.py`` on the
tool's device, seeded with the update's index, as the JAX tool does.

Two behaviours follow the port's own choices:

- the curriculum's own rules. The tool spawns no task: the curriculum never
  evicts by itself, and the tool only follows its pool. A replaced slot is
  compiled with the set's own ``track_stats`` (``MultiTaskEnv.set_task``),
  so on a tracked set (``track_env_stats``, as ``arena_100m``) the port
  swaps in the curriculum's new task where the JAX package, which compiles
  the slot untracked and is refused by the stacked tables, keeps the old
  one. ``set_task`` keeps its ``except ValueError`` for a task of another
  shape class;
- the maps. A map builder with no seed (every recipe's) draws a new map each
  time it builds, so a resumed JAX run steps its restored env states, which
  stand on the saved run's maps, with the tables, the cached static block
  grid and the reset templates of new ones. The port's tool gives each such
  builder a seed drawn from ``trainer.seed`` and the task id
  (``_own_maps``), so that a run's maps are a function of its seed and a
  resumed run rebuilds the maps its saved state stands on.

Randomness lives in the trainer's and the env's ``torch.Generator``s (the
JAX ``TrainState.key``); the trainer state's checkpoint saves and restores
both, so a resumed run draws what the uninterrupted run would.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.compiler import compile_config
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.policy.policy import NetworkPolicy
from metta_tpu_torch.rl.checkpoint import CheckpointManager
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.rl.trainer import Trainer
from metta_tpu_torch.sim.runner import run_simulations
from metta_tpu_torch.tools.tool import Tool
from metta_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


class PolicyConfig(Config):
    """Pydantic view of ViTConfig (``metta_tpu/tools/train.py:29``)."""

    name: str = "vit"
    latent_dim: int = 128
    actor_hidden: int = 256
    critic_hidden: int = 512
    core_num_heads: int = 4
    max_tokens: int = 128
    core_num_latents: int = 12
    token_embed_dim: int = 8
    fourier_freqs: int = 3
    # recurrent core: the reference default "Ag,A,S" Column stack, or "lstm",
    # or any cortex pattern string the port runs (models/cells.py).
    core: str = "Ag,A,S"
    core_layers: int = 2

    def to_arch(self) -> ViTConfig:
        return ViTConfig(
            latent_dim=self.latent_dim, actor_hidden=self.actor_hidden,
            critic_hidden=self.critic_hidden, core_num_heads=self.core_num_heads,
            max_tokens=self.max_tokens, core_num_latents=self.core_num_latents,
            token_embed_dim=self.token_embed_dim, fourier_freqs=self.fourier_freqs,
            core=self.core, core_layers=self.core_layers,
            name=self.name,
        )


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _own_maps(cfg, *seed):
    """``cfg``, or a copy with its map builder seeded from ``seed`` (the
    trainer's seed, and the task id) where it has no seed of its own."""
    if getattr(cfg.game.map_builder, "seed", 0) is not None:
        return cfg
    cfg = cfg.model_copy(deep=True)
    cfg.game.map_builder.seed = int(np.random.SeedSequence(list(seed)).generate_state(1)[0])
    return cfg


class TrainTool(Tool):
    run: str = "local"
    data_dir: str = "./train_dir"
    env: Optional[MettaGridConfig] = None
    trainer: TrainerConfig = Field(default_factory=TrainerConfig)
    policy: PolicyConfig = Field(default_factory=PolicyConfig)
    total_timesteps: Optional[int] = None
    checkpoint_interval: int = 30      # updates between policy bundles
    evaluate_interval: int = 0         # updates between local evals (0=off)
    curriculum_interval: int = 50      # updates between curriculum task swaps
    eval_episodes: int = 4
    log_interval: int = 1
    heartbeat_file: Optional[str] = None
    # failure/abort controls (reference rl/training/wandb_aborter.py: an abort
    # signal polled between updates, plus a wall-clock watchdog)
    abort_file: Optional[str] = None   # training stops cleanly if this exists
    abort_check_interval: int = 5      # updates between abort-file polls
    max_runtime_hrs: float = 0.0       # 0 = unlimited

    # populated programmatically by recipes (not via CLI)
    _curriculum: Any = None
    _simulations: Any = None

    def with_curriculum(self, curriculum) -> "TrainTool":
        object.__setattr__(self, "_curriculum", curriculum)
        return self

    def with_simulations(self, sims) -> "TrainTool":
        object.__setattr__(self, "_simulations", sims)
        return self

    def invoke(self) -> int:
        device = self._apply_device()
        cm = CheckpointManager(self.run, self.data_dir)
        total = self.total_timesteps or self.trainer.total_timesteps

        curriculum = self._curriculum
        arch = self.policy.to_arch()
        seed = self.trainer.seed

        def task_cfg(t):
            return _own_maps(t.get_env_cfg(), seed, t.task_id)

        task = None
        mt_tasks = None
        if curriculum is not None:
            # per-env per-episode curriculum: the whole active pool becomes a
            # task set sampled on the device; weight updates and slot
            # replacement are data of the env
            mt_tasks = curriculum.active_tasks()
            try:
                trainer = Trainer(None, self.trainer, arch, device=device,
                                  task_cfgs=[task_cfg(t) for t in mt_tasks])
                trainer.env.set_weights(
                    curriculum.task_weights([t.task_id for t in mt_tasks]))
            except ValueError:
                # heterogeneous shape classes: fall back to whole-batch swaps
                mt_tasks = None
                task = curriculum.get_task()
                trainer = Trainer(task_cfg(task), self.trainer, arch, device=device)
        else:
            env_cfg = self.env
            if env_cfg is None:
                raise SystemExit("TrainTool needs env= or a curriculum")
            trainer = Trainer(_own_maps(env_cfg, seed), self.trainer, arch, device=device)

        def generators():
            return {"trainer": trainer.generator, "env": trainer.env.generator}

        ts = trainer.init_state()
        restored, meta = cm.load_trainer_state(ts, generators=generators())
        update_idx = 0
        agent_steps = 0
        if restored is not None:
            ts = restored
            update_idx = meta.get("epoch", 0)
            agent_steps = meta.get("extras", {}).get("agent_steps", 0)
            logger.info("resumed from update %d", update_idx)

        steps_per_update = trainer.B * trainer.T
        t0 = time.time()
        last_log_steps = agent_steps
        last_log_t = t0

        mlog = MetricsLogger(run_dir=os.path.join(self.data_dir, self.run),
                             run_name=self.run)
        res_names = list(trainer.env.compiled.resource_names)

        while agent_steps < total:
            if self.abort_file and self.abort_check_interval and \
                    update_idx % self.abort_check_interval == 0 and \
                    os.path.exists(self.abort_file):
                logger.warning("abort file %s present — stopping cleanly", self.abort_file)
                break
            if self.max_runtime_hrs and (time.time() - t0) > self.max_runtime_hrs * 3600:
                logger.warning("max_runtime_hrs %.2f reached — stopping cleanly",
                               self.max_runtime_hrs)
                break
            ts, metrics = trainer.update(ts)
            update_idx += 1
            agent_steps += steps_per_update

            if self.log_interval and update_idx % self.log_interval == 0:
                # agent-steps over wall time since the last log line, the
                # checkpoint and curriculum sync between them included
                now = time.time()
                sps = (agent_steps - last_log_steps) / max(now - last_log_t, 1e-9)
                last_log_steps, last_log_t = agent_steps, now
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    "update %d  steps %d  overview/sps %.0f  reward %.4f  pg %.4f  vf %.4f  "
                    "ent %.3f", update_idx, agent_steps, sps, m.get("reward_mean", 0),
                    m.get("policy_loss", 0), m.get("value_loss", 0), m.get("entropy", 0),
                )
                payload = {
                    "agent_step": agent_steps,
                    "overview/sps": sps,
                    "overview/reward": m.get("reward_mean", 0.0),
                    **{f"losses/{k}": v for k, v in m.items()},
                }
                if self.trainer.track_env_stats:
                    # env_agent/<resource>.gained (the gate devops/stable.py
                    # reads), averaged over the episodes finished since the
                    # last log line: last_episode_gained is sticky per env
                    vst = ts.vstate
                    eps_done = getattr(vst, "episodes_done", None)
                    if eps_done is not None:
                        eps_done = _np(eps_done)
                        prev = getattr(self, "_eps_done_prev", None)
                        done_mask = (eps_done > prev) if prev is not None else (eps_done > 0)
                        self._eps_done_prev = eps_done
                    else:
                        done_mask = _np(vst.episode_len) > 0
                    if done_mask.any():
                        gained = _np(vst.last_episode_gained)[done_mask]
                        for ri, rn in enumerate(res_names):
                            payload[f"env_agent/{rn}.gained"] = float(gained[:, ri].mean())
                mlog.log(payload, step=agent_steps)

            if self.heartbeat_file:
                # reference common/util/heartbeat.py record_heartbeat
                try:
                    with open(self.heartbeat_file, "w") as f:
                        f.write(str(time.time()))
                except OSError:
                    pass

            if self.checkpoint_interval and update_idx % self.checkpoint_interval == 0:
                cm.save_policy(trainer.state_dict(ts.params), arch, epoch=update_idx)
                cm.save_trainer_state(ts, update_idx, extras={"agent_steps": agent_steps},
                                      generators=generators())

            if mt_tasks is not None:
                # per-task scoring from the envs' last finished episodes
                # (mean per-step reward, as the reference scores completions)
                vst = ts.vstate
                ep_len = _np(vst.episode_len)
                ep_task = _np(vst.last_episode_task)
                ep_rew = _np(vst.last_episode_reward).mean(axis=1)
                for k, t in enumerate(mt_tasks):
                    m = (ep_task == k) & (ep_len > 0)
                    if m.any():
                        score = float((ep_rew[m] / np.maximum(ep_len[m], 1)).mean())
                        curriculum.update_task_performance(t.task_id, score)
                if self.curriculum_interval and update_idx % self.curriculum_interval == 0:
                    # refill the slots whose task left the pool, refresh the
                    # sampling weights: data of the env only
                    live = {t.task_id: t for t in curriculum.active_tasks()}
                    in_slots = {t.task_id for t in mt_tasks}
                    fresh_pool = [t for tid, t in live.items() if tid not in in_slots]
                    for k, t in enumerate(mt_tasks):
                        if t.task_id not in live and fresh_pool:
                            new_t = fresh_pool.pop()
                            try:
                                trainer.env.set_task(k, task_cfg(new_t))
                                mt_tasks[k] = new_t
                            except ValueError:
                                logger.warning(
                                    "curriculum task %d not shape-compatible; keeping slot",
                                    new_t.task_id)
                    trainer.env.set_weights(
                        curriculum.task_weights([t.task_id for t in mt_tasks]))
            elif task is not None:
                # fallback path: whole-batch task, swapped at update granularity
                curriculum.update_task_performance(task.task_id, float(metrics["reward_mean"]))
                if self.curriculum_interval and update_idx % self.curriculum_interval == 0:
                    new_task = curriculum.get_task()
                    if new_task.task_id != task.task_id:
                        task = new_task
                        trainer = Trainer(task_cfg(task), self.trainer, arch, device=device)
                        fresh = trainer.init_state()
                        ts = dataclasses.replace(fresh, params=ts.params,
                                                 opt_state=ts.opt_state, r_bar=ts.r_bar,
                                                 update_idx=ts.update_idx)

            if self.evaluate_interval and update_idx % self.evaluate_interval == 0 \
                    and self._simulations:
                uri = cm.save_policy(trainer.state_dict(ts.params), arch, epoch=update_idx)
                pol = NetworkPolicy.from_bundle(uri, compile_config(self._simulations[0].env),
                                                n_slots=1, device=device)
                results = run_simulations([pol], self._simulations, seed=update_idx,
                                          device=device)
                for r in results:
                    logger.info("eval %s: mean_reward %.4f", r.key, r.mean_reward)

        cm.save_policy(trainer.state_dict(ts.params), arch, epoch=update_idx)
        cm.save_trainer_state(ts, update_idx, extras={"agent_steps": agent_steps},
                              generators=generators())
        mlog.close()
        logger.info("done: %d agent steps in %.1fs", agent_steps, time.time() - t0)
        return 0
