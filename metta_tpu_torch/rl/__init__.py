"""Learner of the port: advantages, PPO trainer, optimizer, checkpoints."""
