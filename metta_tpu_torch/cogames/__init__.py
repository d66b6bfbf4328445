"""Cogs vs Clips, the port's own copy of ``metta_tpu/cogames``: the
missions' stations, variants, sites, catalog and evals, and the simple
missions of ``missions.py``. The CLI, the scripted agents and the
procedural missions are not ported."""

from metta_tpu_torch.cogames.missions import MISSIONS, make_mission

__all__ = ["MISSIONS", "make_mission"]
