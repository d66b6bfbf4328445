from metta_tpu_torch.policy.policy import (
    AgentPolicy,
    MultiAgentPolicy,
    NetworkPolicy,
    NoopPolicy,
    RandomPolicy,
)

__all__ = ["AgentPolicy", "MultiAgentPolicy", "NetworkPolicy", "NoopPolicy", "RandomPolicy"]
