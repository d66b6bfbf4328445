"""Trainer configuration, the port's trimmed copy of ``metta_tpu/rl/config.py``.

Same names and defaults as the JAX tree for what the port runs: the
optimizer, the advantage and reward centering, the PPO actor and critic
(both critic modes), sequential sampling and the workload shape. What the
port does not run is refused with ``NotImplementedError`` naming the JAX
source: every loss family other than ``ppo_actor``/``ppo_critic``,
prioritized sampling, recurrent burn-in, schedules, the update-epochs
autotuner, the profiler hook and chunked rollouts (the gradient statistics
of ``grad_stats`` are not kept either: the field is refused as unknown).
"""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import Field, model_validator

from metta_tpu_torch.config.base import Config


class OptimizerConfig(Config):
    type: Literal["adam", "adamw", "adamw_schedulefree", "sgd"] = "adamw_schedulefree"
    learning_rate: float = Field(default=0.00737503357231617, gt=0, le=1.0)
    beta1: float = Field(default=0.9, ge=0, le=1.0)
    beta2: float = Field(default=0.999, ge=0, le=1.0)
    eps: float = Field(default=5.0833278919526e-07, gt=0)
    weight_decay: float = Field(default=0.01, ge=0)
    warmup_steps: int = Field(default=1000, ge=0)


class RewardCenteringConfig(Config):
    enabled: bool = True
    beta: float = Field(default=1e-3, gt=0, le=1.0)
    initial_reward_mean: float = 0.0


class AdvantageConfig(Config):
    vtrace_rho_clip: float = Field(default=1.0, gt=0)
    vtrace_c_clip: float = Field(default=1.0, gt=0)
    reward_centering: RewardCenteringConfig = Field(default_factory=RewardCenteringConfig)
    gamma: float = Field(default=1.0, ge=0, le=1.0)
    gae_lambda: float = Field(default=0.95, ge=0, le=1.0)


class PPOActorConfig(Config):
    clip_coef: float = Field(default=0.22017136216163635, gt=0, le=1.0)
    ent_coef: float = Field(default=0.01, ge=0)
    norm_adv: bool = True
    target_kl: Optional[float] = None


class PPOCriticConfig(Config):
    vf_clip_coef: float = Field(default=0.1, ge=0)
    vf_coef: float = Field(default=0.49657103419303894, ge=0)
    clip_vloss: bool = True
    critic_update: Literal["mse", "gtd_lambda"] = "gtd_lambda"
    aux_coef: float = Field(default=1.0, ge=0)
    beta: float = Field(default=1.0, ge=0)
    burn_in_steps: int = Field(default=0, ge=0)

    @model_validator(mode="after")
    def _ported(self):
        if self.burn_in_steps > 0:
            raise NotImplementedError(
                "ppo_critic.burn_in_steps > 0 is not ported (metta_tpu/rl/trainer.py:401)")
        return self


class LossesConfig(Config):
    """PPO actor and critic; the JAX package's other loss families
    (``metta_tpu/rl/losses.py``) are refused."""

    ppo_actor: PPOActorConfig = Field(default_factory=PPOActorConfig)
    ppo_critic: PPOCriticConfig = Field(default_factory=PPOCriticConfig)

    @model_validator(mode="before")
    @classmethod
    def _ported(cls, data):
        other = sorted(set(dict(data or {})) - {"ppo_actor", "ppo_critic"})
        if other:
            raise NotImplementedError(
                f"loss families {other} are not ported (metta_tpu/rl/losses.py)")
        return data


class SamplingConfig(Config):
    """Minibatch sampling: sequential slices of a per-epoch row permutation."""

    method: str = "sequential"
    prio_alpha: float = Field(default=0.8, ge=0.0)
    prio_beta0: float = Field(default=0.6, ge=0.0, le=1.0)

    @model_validator(mode="after")
    def _ported(self):
        if self.method == "prioritized" and self.prio_alpha > 0.0:
            raise NotImplementedError(
                "prioritized sampling is not ported (metta_tpu/rl/trainer.py:731-747)")
        return self


class TrainerConfig(Config):
    total_timesteps: int = Field(default=10_000_000_000, gt=0)
    losses: LossesConfig = Field(default_factory=LossesConfig)
    optimizer: OptimizerConfig = Field(default_factory=OptimizerConfig)
    advantage: AdvantageConfig = Field(default_factory=AdvantageConfig)

    # batch_size = rollout_rows x bptt_horizon agent-steps per update
    batch_size: int = Field(default=2_097_152, gt=0)
    minibatch_size: int = Field(default=16384, gt=0)
    bptt_horizon: int = Field(default=256, gt=0)
    update_epochs: int = Field(default=1, gt=0)
    # 0: derived from batch_size / bptt / num_agents
    num_envs: int = Field(default=0, ge=0)

    max_grad_norm: float = Field(default=0.5, gt=0)
    seed: int = 0
    track_env_stats: bool = False
    env_step_mode: str = "batched"
    sampling: SamplingConfig = Field(default_factory=SamplingConfig)

    @model_validator(mode="before")
    @classmethod
    def _ported(cls, data):
        unported = {
            "scheduler": "schedules (metta_tpu/rl/scheduler.py)",
            "autotuner": "the update-epochs autotuner (metta_tpu/rl/autotuner.py)",
            "profiler": "the profiler hook (metta_tpu/rl/trainer.py:875-890)",
        }
        data = dict(data or {})
        for key, what in unported.items():
            if data.get(key) is not None:
                raise NotImplementedError(f"{what} is not ported")
        if data.get("rollout_chunks", 1) != 1:
            raise NotImplementedError(
                "rollout_chunks > 1 is not ported (metta_tpu/rl/trainer.py:641-673)")
        data.pop("rollout_chunks", None)
        for key in unported:
            data.pop(key, None)
        return data
