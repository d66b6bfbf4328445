"""Recipes of the port: functions returning configured tools, run as
``python -m metta_tpu_torch.tools.run metta_tpu_torch.recipes.<module>.<function>``."""
