"""PPO actor-learner on one torch device.

Counterpart of ``metta_tpu/rl/trainer.py``, over one task or a task set
(``task_cfgs``: the curriculum's active pool as a ``MultiTaskEnv``, every env
drawing a new task at each episode's end; the curriculum's updates between
batches are data of the env, ``set_weights`` and ``set_task``):
``Trainer.update`` is one train batch, a rollout of ``bptt_horizon`` steps
through the env and the policy into a [T, B] trajectory on the device, the
advantages (kernel K3 on the card), then ``update_epochs`` passes of PPO
minibatches with the clipped policy loss, entropy and either critic (the
default GTD(λ), whose TD(λ) targets are differentiated through K3's
backward, or the clipped value MSE), and the optimizer (``rl/optim.py``).

The policy's parameters are one flat float32 vector (``TrainState.params``);
the policy runs on views of it (``torch.func.functional_call``), so the
gradient and the optimizer work on one vector. Randomness is explicit: a
``torch.Generator`` on the trainer's device draws the action samples
(Gumbel-max, as ``jax.random.categorical``) and each epoch's row
permutation; the env draws its agent orders from its own generator.

Recurrent state: persistent during rollout (every leaf zeroed for the agents
of envs that ended), zero per BPTT segment in the learner.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
from torch.func import functional_call

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.engine.state import VecEnvState
from metta_tpu_torch.engine.taskset import MultiTaskEnv
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl.advantage import compute_delta_lambda, normalize_advantage, puff_advantage
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.rl.optim import make_optimizer
from metta_tpu_torch.rl.scheduler import HP_FIELDS, HP_INDEX


@dataclass
class TrainState:
    params: torch.Tensor          # [P] f32, the policy's parameters as one vector
    opt_state: dict
    vstate: VecEnvState           # an MTVecState over a task set
    obs: torch.Tensor             # [E, A, T_tok, 3] uint8 (current)
    core: Any                     # recurrent state: the LSTM's (c, h), each [B, H], or
                                  # the cortex stack's tree of [B, ...] leaves
    prev_reward: torch.Tensor     # [B] f32, reward received with the current obs
    prev_done: torch.Tensor       # [B] f32, done flag of the current obs
    r_bar: torch.Tensor           # [] f32 reward-centering EMA
    update_idx: int = 0


@dataclass
class Trajectory:
    obs: torch.Tensor       # [T, B, K, 3] uint8
    actions: torch.Tensor   # [T, B] int64
    logprob: torch.Tensor   # [T, B] f32
    value: torch.Tensor     # [T, B] f32
    reward: torch.Tensor    # [T, B] f32, received on arriving at obs_t
    done: torch.Tensor      # [T, B] f32, obs_t begins a new episode


def zero_ended(core, ended):
    """Every leaf of the recurrent state (the LSTM's tuple or the cortex
    stack's nested dict) with the rows where ``ended`` [B] is set zeroed, the
    mask shaped to the leaf's rank (``metta_tpu/rl/trainer.py:287-289``)."""
    if isinstance(core, dict):
        return {k: zero_ended(v, ended) for k, v in core.items()}
    if isinstance(core, tuple):
        return tuple(zero_ended(v, ended) for v in core)
    mask = ended.reshape((-1,) + (1,) * (core.dim() - 1))
    return torch.where(mask, torch.zeros_like(core), core)


class ParamLayout:
    """Names, shapes and offsets of a module's parameters in one flat vector."""

    def __init__(self, module: torch.nn.Module):
        self.names, self.shapes, self.offsets = [], [], [0]
        for name, p in module.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            self.offsets.append(self.offsets[-1] + p.numel())
        self.size = self.offsets[-1]

    def flatten(self, tensors: dict, device) -> torch.Tensor:
        """{name: tensor} -> [P] float32 (every name of the layout)."""
        return torch.cat([tensors[n].detach().reshape(-1).to(torch.float32)
                          for n in self.names]).to(device)

    def views(self, flat: torch.Tensor) -> dict:
        """[P] -> {name: view of ``flat`` in the parameter's shape}."""
        return {n: flat[a:b].view(s) for n, s, a, b in
                zip(self.names, self.shapes, self.offsets, self.offsets[1:])}


class Trainer:
    """Single-device trainer over one task or a task set.

    Args:
      env_cfg: the training env's config (None with ``task_cfgs``).
      trainer_cfg: ``TrainerConfig`` (defaults as the JAX package's).
      policy_cfg: ``ViTConfig`` (default the ``"Ag,A,S"`` cortex core).
      num_envs: env batch; default ``cfg.num_envs`` or batch_size / (T·A).
      device: where the env, the policy and the learner run; "cuda" by default.
      task_cfgs: train over this task set instead (``engine/taskset.py``).
    """

    def __init__(self, env_cfg: Optional[MettaGridConfig],
                 trainer_cfg: Optional[TrainerConfig] = None,
                 policy_cfg: Optional[ViTConfig] = None, num_envs: Optional[int] = None,
                 device="cuda", task_cfgs: Optional[list] = None):
        self.cfg = trainer_cfg or TrainerConfig()
        cfg = self.cfg
        self.device = torch.device(device)
        multi_task = task_cfgs is not None
        A = (task_cfgs[0] if multi_task else env_cfg).game.num_agents
        T = cfg.bptt_horizon
        if num_envs is None:
            num_envs = cfg.num_envs or max(cfg.batch_size // (T * A), 1)
        env_kw = dict(num_envs=num_envs, seed=cfg.seed, track_stats=cfg.track_env_stats,
                      step_mode=cfg.env_step_mode, device=self.device)
        self.env = (MultiTaskEnv(task_cfgs, **env_kw) if multi_task
                    else MettaGridEnv(env_cfg, **env_kw))
        self.E, self.A, self.B, self.T = num_envs, A, num_envs * A, T
        self.rows_per_mb = max(cfg.minibatch_size // T, 1)
        while self.B % self.rows_per_mb != 0:          # shrink to a divisor
            self.rows_per_mb -= 1
        self.n_minibatches = self.B // self.rows_per_mb

        self.policy_cfg = policy_cfg or ViTConfig()
        self.policy = self._make_policy(cfg.seed).to(self.device)
        self.layout = ParamLayout(self.policy)
        self.tx = make_optimizer(cfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.agent_steps = 0

    def _make_policy(self, seed: int):
        """The policy with parameters drawn on the CPU from ``seed``, so
        that every device starts from the same numbers."""
        c = self.env.compiled
        return self.policy_cfg.make(c.n_actions, c.feature_normalizations,
                                    generator=torch.Generator().manual_seed(seed))

    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None, params: Optional[dict] = None) -> TrainState:
        """Reset the envs and start the learner: parameters from ``params`` (a
        ``state_dict``, e.g. from ``rl/checkpoint.py``) or drawn from
        ``seed`` (default ``cfg.seed``) on the CPU."""
        seed = self.cfg.seed if seed is None else seed
        self.generator.manual_seed(seed)
        self.env.generator.manual_seed(seed)
        if params is None:
            params = self._make_policy(seed).state_dict()
        flat = self.layout.flatten(params, self.device)
        vstate, obs = self.env.reset_state()
        zeros = torch.zeros((self.B,), dtype=torch.float32, device=self.device)
        return TrainState(
            params=flat, opt_state=self.tx.init(flat), vstate=vstate, obs=obs,
            core=self.policy.initial_state(self.B, self.device),
            prev_reward=zeros, prev_done=zeros.clone(),
            r_bar=torch.tensor(self.cfg.advantage.reward_centering.initial_reward_mean,
                               dtype=torch.float32, device=self.device),
        )

    def state_dict(self, params: torch.Tensor) -> dict:
        """The policy's ``state_dict`` at ``params`` (CPU copies)."""
        return {n: v.detach().cpu().clone() for n, v in self.layout.views(params).items()}

    def apply(self, params, obs, core):
        """The policy at ``params``: (logits, value, h_value, new_core)."""
        return functional_call(self.policy, self.layout.views(params), (obs, core))

    # ------------------------------------------------------------------

    def _sample(self, logits):
        """Gumbel-max draw of one action per row (``jax.random.categorical``)."""
        u = torch.rand(logits.shape, generator=self.generator, device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    @torch.no_grad()
    def _rollout(self, ts: TrainState):
        E, A, B, T = self.E, self.A, self.B, self.T
        K = min(self.policy_cfg.max_tokens, ts.obs.shape[2])   # tokens the policy reads
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        traj = Trajectory(
            obs=torch.empty((T, B, K, 3), dtype=torch.uint8, device=dev),
            actions=torch.empty((T, B), dtype=torch.int64, device=dev),
            logprob=torch.empty((T, B), **f32), value=torch.empty((T, B), **f32),
            reward=torch.empty((T, B), **f32), done=torch.empty((T, B), **f32),
        )
        vstate, obs, core = ts.vstate, ts.obs, ts.core
        prev_rew, prev_done = ts.prev_reward, ts.prev_done
        for t in range(T):
            obs_flat = obs.reshape(B, obs.shape[2], 3)
            logits, value, _, core = self.apply(ts.params, obs_flat, core)
            action = self._sample(logits)
            traj.obs[t] = obs_flat[:, :K]
            traj.actions[t] = action
            traj.logprob[t] = torch.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
            traj.value[t] = value
            traj.reward[t] = prev_rew
            traj.done[t] = prev_done
            vstate, obs, rew, done, trunc = self.env.step_state(
                vstate, action.reshape(E, A).to(torch.int32))
            prev_done = (done | trunc).to(torch.float32).repeat_interleave(A)    # [B]
            core = zero_ended(core, prev_done > 0)
            prev_rew = rew.reshape(-1)
        ts = replace(ts, vstate=vstate, obs=obs, core=core, prev_reward=prev_rew,
                     prev_done=prev_done)
        return ts, traj

    # ------------------------------------------------------------------

    def _sequence_forward(self, params, obs_seq):
        """Forward a [T, M, K, 3] segment from a zero core -> (logits, value,
        h_value), each [T, M, ...]."""
        core0 = self.policy.initial_state(obs_seq.shape[1], obs_seq.device)
        logits, value, h_value, _ = self.apply(params, obs_seq, core0)
        return logits, value, h_value

    def _loss_fn(self, params, mb, hp):
        """Total loss and metrics on one minibatch dict of [T, M] tensors;
        ``hp`` is the scheduled-coefficient vector (``HP_FIELDS`` order)."""
        cfg = self.cfg
        ac, cc = cfg.losses.ppo_actor, cfg.losses.ppo_critic
        clip_coef = hp[HP_INDEX["ppo_clip_coef"]]
        ent_coef = hp[HP_INDEX["ppo_ent_coef"]]
        vf_coef = hp[HP_INDEX["vf_coef"]]

        logits, value, h_value = self._sequence_forward(params, mb["obs"])
        logp_all = torch.log_softmax(logits, -1)                         # [T, M, n_act]
        new_logp = logp_all.gather(2, mb["actions"][..., None])[..., 0]
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
        logratio = torch.clamp(new_logp - mb["logprob"], -10.0, 10.0)
        ratio = torch.exp(logratio)
        # every row is a PPO row: the loss families that reserve rows
        # (``metta_tpu/rl/losses.py:592 ppo_row_mask``) are not ported

        if cc.critic_update == "gtd_lambda":
            dl = compute_delta_lambda(value, mb["reward"], mb["done"],
                                      cfg.advantage.gamma, cfg.advantage.gae_lambda)
            adv = dl                                                     # actor uses δλ
            dl_t, v_t, h_t = dl[:-1], value[:-1], h_value[:-1]
            h_sg, dl_sg = h_t.detach(), dl_t.detach()
            critic_loss = (h_sg * dl_t).mean() - ((dl_sg - h_sg) * v_t).mean()
            leaves = [v for n, v in self.layout.views(params).items() if n.startswith("gtd_aux.")]
            l2 = sum((p * p).sum() for p in leaves) / max(sum(p.numel() for p in leaves), 1)
            aux_loss = 0.5 * ((dl_sg - h_t) ** 2).mean() + 0.5 * cc.beta * l2
            v_loss = vf_coef * critic_loss + cc.aux_coef * aux_loss
        else:
            adv = mb["advantages"]
            returns = mb["advantages"] + mb["value"]
            if cc.clip_vloss:
                v_unclipped = (value - returns) ** 2
                v_clipped_pred = mb["value"] + torch.clamp(
                    value - mb["value"], -cc.vf_clip_coef, cc.vf_clip_coef)
                v_clipped = (v_clipped_pred - returns) ** 2
                v_loss = 0.5 * torch.maximum(v_unclipped, v_clipped).mean()
            else:
                v_loss = 0.5 * ((value - returns) ** 2).mean()
            v_loss = vf_coef * v_loss

        adv = adv.detach()
        if ac.norm_adv:
            adv = normalize_advantage(adv)
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
        pg_loss = torch.maximum(pg1, pg2).mean()
        ent_loss = entropy.mean()
        loss = pg_loss - ent_coef * ent_loss + v_loss

        with torch.no_grad():
            approx_kl = ((ratio - 1) - logratio).mean()
            clipfrac = ((ratio - 1.0).abs() > ac.clip_coef).to(torch.float32).mean()
        metrics = dict(policy_loss=pg_loss.detach(), value_loss=v_loss.detach(),
                       entropy=ent_loss.detach(), approx_kl=approx_kl, clipfrac=clipfrac)
        return loss, metrics

    # ------------------------------------------------------------------

    def default_hp(self) -> list:
        """Base scheduled-coefficient vector from the config."""
        ls = self.cfg.losses
        base = {name: 0.0 for name in HP_FIELDS}
        base.update({
            "ppo_clip_coef": ls.ppo_actor.clip_coef,
            "ppo_ent_coef": ls.ppo_actor.ent_coef,
            "vf_coef": ls.ppo_critic.vf_coef,
        })
        return [float(base[n]) for n in HP_FIELDS]

    def update(self, ts: TrainState, hp=None):
        """One train batch: rollout, advantages, PPO epochs -> (ts, metrics of
        0-dim device tensors). ``hp`` overrides the scheduled coefficients."""
        hp = self.default_hp() if hp is None else [float(h) for h in hp]
        ts, traj = self._rollout(ts)
        return self._learn_phase(ts, traj, hp)

    def _learn_phase(self, ts: TrainState, traj: Trajectory, hp):
        cfg = self.cfg
        adv_cfg = cfg.advantage
        B, dev = self.B, self.device
        rc = adv_cfg.reward_centering
        r_bar = ts.r_bar
        rewards_c = traj.reward
        if rc.enabled:
            r_bar = r_bar + rc.beta * (traj.reward.mean() - r_bar)
            rewards_c = traj.reward - r_bar
        advantages = puff_advantage(
            traj.value, rewards_c, traj.done, torch.ones_like(traj.value),
            adv_cfg.gamma, adv_cfg.gae_lambda, adv_cfg.vtrace_rho_clip, adv_cfg.vtrace_c_clip)
        data = dict(obs=traj.obs, actions=traj.actions, logprob=traj.logprob,
                    value=traj.value, reward=rewards_c, done=traj.done, advantages=advantages)

        target_kl = cfg.losses.ppo_actor.target_kl
        params, opt_state = ts.params, ts.opt_state
        stop = torch.zeros((), dtype=torch.float32, device=dev)
        msum = {}
        rows_mb = self.rows_per_mb
        for _ in range(cfg.update_epochs):
            perm = torch.randperm(B, generator=self.generator, device=dev)
            for i in range(self.n_minibatches):
                rows = perm[i * rows_mb:(i + 1) * rows_mb]
                mb = {k: v.index_select(1, rows) for k, v in data.items()}
                p = params.detach().requires_grad_()
                loss, metrics = self._loss_fn(p, mb, hp)
                (grads,) = torch.autograd.grad(loss, p)
                with torch.no_grad():
                    updates, opt_new = self.tx.update(grads, opt_state, params)
                    if target_kl is None:
                        params, opt_state = params + updates, opt_new
                    else:
                        # KL early stop: once the KL exceeds the target, the
                        # remaining minibatch updates of this phase are no-ops
                        params = params + updates * (1.0 - stop)
                        opt_state = {k: torch.where(stop > 0, opt_state[k], v)
                                     for k, v in opt_new.items()}
                        stop = torch.where(metrics["approx_kl"] > target_kl,
                                           torch.ones_like(stop), stop)
                    for k, v in metrics.items():
                        msum[k] = msum[k] + v if k in msum else v
        n_updates = cfg.update_epochs * self.n_minibatches
        metrics = {k: v / n_updates for k, v in msum.items()}
        metrics["reward_mean"] = traj.reward.mean()
        metrics["r_bar"] = r_bar
        metrics["value_mean"] = traj.value.mean()
        if target_kl is not None:
            metrics["kl_early_stop"] = stop
        ts = replace(ts, params=params.detach(), opt_state=opt_state, r_bar=r_bar,
                     update_idx=ts.update_idx + 1)
        return ts, metrics

    # ------------------------------------------------------------------

    def train(self, total_timesteps: Optional[int] = None, ts: Optional[TrainState] = None,
              log_fn: Optional[Callable] = None):
        """Update until ``agent_steps`` reaches ``total_timesteps``; ``log_fn``
        gets each update's metrics as floats with ``agent_steps`` and
        ``sps`` (agent-steps per second since the call began)."""
        total = total_timesteps or self.cfg.total_timesteps
        if ts is None:
            ts = self.init_state()
        steps_per_update = self.B * self.T
        t0 = time.time()
        while self.agent_steps < total:
            ts, metrics = self.update(ts)
            self.agent_steps += steps_per_update
            if log_fn is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m["agent_steps"] = self.agent_steps
                m["sps"] = self.agent_steps / max(time.time() - t0, 1e-9)
                log_fn(m)
        return ts
