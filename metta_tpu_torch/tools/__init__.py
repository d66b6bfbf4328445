"""Tools of the port: the training, evaluation, play and replay entry points
and the CLI."""

from metta_tpu_torch.tools.evaluate import EvaluateTool
from metta_tpu_torch.tools.play import PlayTool, ReplayTool
from metta_tpu_torch.tools.tool import Tool, cli_entry
from metta_tpu_torch.tools.train import PolicyConfig, TrainTool

__all__ = ["EvaluateTool", "PlayTool", "PolicyConfig", "ReplayTool", "Tool", "TrainTool",
           "cli_entry"]
