"""Tools of the port: the training entry point and the CLI."""

from metta_tpu_torch.tools.tool import Tool, cli_entry
from metta_tpu_torch.tools.train import PolicyConfig, TrainTool

__all__ = ["PolicyConfig", "Tool", "TrainTool", "cli_entry"]
