from metta_tpu_torch.envs.pettingzoo_env import PettingZooEnv

__all__ = ["PettingZooEnv"]
