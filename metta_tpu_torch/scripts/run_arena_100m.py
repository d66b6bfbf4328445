"""Run the arena_100m stable job with the reference-default "Ag,A,S" core.

Counterpart of ``scripts/run_arena_100m.py``:

    python -m metta_tpu_torch.scripts.run_arena_100m [--seed 0] [--out DIR]
        [--data-dir DIR] [--max-minutes M]

runs ``STABLE_JOBS["arena_100m"]``'s tool on the card, resuming from the run's
own trainer state where one is saved under ``--data-dir``, and writes
``RESULTS_arena_100m.json`` and ``metrics.jsonl`` into ``--out`` (default
``devops_runs/stable_100m_torch_s<seed>``). ``--max-minutes`` (the tool's
``max_runtime_hrs``, as ``scripts/run_arena_2b.py`` sets it) ends the run
cleanly, with its trainer state saved, before the first update that starts
after that many minutes: a run split over several sessions of bounded
length gives each the session's length less one update and a save (the job
saves only every 30 updates otherwise). The JAX script's ``--chunks``
(``rollout_chunks``) is not here: the port refuses chunked rollouts.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--data-dir", type=str, default="./train_dir")
    ap.add_argument("--max-minutes", type=float, default=0.0, help="0: no limit")
    args = ap.parse_args(argv)

    from metta_tpu_torch.devops.stable import STABLE_JOBS, evaluate_acceptance

    job = STABLE_JOBS["arena_100m"]
    tool = job.make_tool()
    tool.trainer.seed = args.seed
    tool.max_runtime_hrs = args.max_minutes / 60.0
    print(f"arena_100m seed={args.seed} core={tool.policy.core} "
          f"max_minutes={args.max_minutes}", flush=True)
    object.__setattr__(tool, "data_dir", args.data_dir)
    rc = tool.invoke()
    run_dir = Path(args.data_dir) / tool.run
    result = evaluate_acceptance(job, run_dir)
    result["exit_code"] = rc
    result["seed"] = args.seed
    result["policy_core"] = tool.policy.core
    out = Path(args.out or f"devops_runs/stable_100m_torch_s{args.seed}")
    out.mkdir(parents=True, exist_ok=True)
    (out / "RESULTS_arena_100m.json").write_text(json.dumps(result, indent=2))
    src = run_dir / "metrics.jsonl"
    if src.exists():
        shutil.copy(src, out / "metrics.jsonl")
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
