"""Runtime-scheduled coefficients, the port's copy of
``metta_tpu/rl/scheduler.py:22-43`` (``HP_FIELDS``, ``HP_INDEX``).

The order of the hp vector the trainer's loss reads, one entry per loss
family. The schedules themselves are not ported (``TrainerConfig`` refuses
``scheduler``).
"""

HP_FIELDS = [
    "ppo_clip_coef",
    "ppo_ent_coef",
    "vf_coef",
    "kickstarter_coef",
    "action_supervised_coef",
    "sliced_kickstarter_coef",
    "logit_kickstarter_coef",
    "scripted_cloner_coef",
    "sl_kickstarter_coef",
    "eer_kickstarter_coef",
    "eer_cloner_coef",
    "ema_coef",
    "cmpo_coef",
    "grpo_coef",
    "quantile_vf_coef",
    "contrastive_coef",
    "stable_latent_coef",
    "future_latent_coef",
    "vit_recon_coef",
]
HP_INDEX = {name: i for i, name in enumerate(HP_FIELDS)}
