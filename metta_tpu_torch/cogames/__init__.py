"""Cogs vs Clips, the port's own copy of ``metta_tpu/cogames``: the
missions' stations, variants, sites, catalog and evals, and the simple
missions of ``missions.py``, the procedural and difficulty variants, the
scripted baseline agents and the ``cogames`` CLI (``python -m
metta_tpu_torch.cogames``)."""

from metta_tpu_torch.cogames.missions import MISSIONS, make_mission

__all__ = ["MISSIONS", "make_mission"]
