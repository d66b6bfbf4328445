"""Tool framework: pydantic configs as CLI entry points.

Counterpart of ``metta_tpu/tools/tool.py`` (reference
``common/src/metta/common/tool/`` + ``tools/run.py``): a recipe module
exposes functions returning configured Tool instances; the CLI
(``python -m metta_tpu_torch.tools.run``) loads ``module.function``, applies
``key=value`` overrides onto the pydantic tree, and invokes the tool.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Optional

import torch

from metta_tpu_torch.config.base import Config


class Tool(Config):
    """Base class: a pydantic config with an ``invoke`` method.

    ``device``: the torch device the tool runs on; None means ``"cuda"``,
    and ``"cpu"`` is how tests ask for the CPU. A tool never falls back to
    the CPU: without a card, ``"cuda"`` raises.
    """

    device: Optional[str] = None

    def invoke(self) -> Optional[int]:
        raise NotImplementedError

    def _apply_device(self) -> torch.device:
        """The tool's torch device, with TF32 pinned off so that float32
        matmuls stay float32 on the card (as ``chip_smoke.py`` pins it)."""
        device = torch.device(self.device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for (device=None means cuda), and "
                               f"torch finds no CUDA device; pass device=cpu for the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return device


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("none", "null"):
        return None
    return value


def apply_overrides(tool: Tool, overrides: list) -> Tool:
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"Override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        tool.override(key, _coerce(value))
    return tool


def load_tool(path: str) -> Tool:
    """Load ``module.function`` (or a module with a ``train``/``tool`` function),
    e.g. ``metta_tpu_torch.recipes.navigation.train``."""
    mod_path, _, fn_name = path.rpartition(".")
    try:
        mod = importlib.import_module(path)
        fn = getattr(mod, "train", None) or getattr(mod, "tool", None)
        if fn is None:
            raise AttributeError
    except (ImportError, AttributeError):
        mod = importlib.import_module(mod_path)
        fn = getattr(mod, fn_name)
    tool = fn()
    if not isinstance(tool, Tool):
        raise SystemExit(f"{path} did not return a Tool (got {type(tool)})")
    return tool


def cli_entry(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m metta_tpu_torch.tools.run <module.function> [key=value ...]")
        return 2
    tool = load_tool(argv[0])
    apply_overrides(tool, argv[1:])
    return tool.invoke() or 0
