"""CLI entry: ``python -m metta_tpu_torch.tools.run <module.function> [key=value ...]``.

Counterpart of ``tools/run.py``, e.g.

    python -m metta_tpu_torch.tools.run metta_tpu_torch.recipes.navigation.train \\
        device=cpu run=nav trainer.total_timesteps=4096

runs on the card unless ``device=cpu`` is given.
"""

import logging

from metta_tpu_torch.tools.tool import cli_entry

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    raise SystemExit(cli_entry())
