"""Render the port's SLURM template and submit it (counterpart of
``slurm/launch.py``; ref ``SLURM/slurm-launch.py``).

    python nuzero_tpu_torch/slurm/launch.py --num-nodes 2 --gpus-per-node 8 \
        --args "--training-preset 2 --filters 256 --net-dtype bfloat16"

The job runs ``python -m nuzero_tpu_torch ARGS`` as one task per card
(``--ntasks-per-node`` = ``--gpus-per-node``): the port runs one process
per card where the JAX package runs one per host.  Each task joins the
process group from SLURM's variables and ``JAX_COORDINATOR``
(``parallel/distributed.py``).  ``--dry-run`` prints the script.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def render(job_name: str, num_nodes: int, gpus_per_node: int, partition: str,
           time_limit: str, args: str) -> str:
    """The job script: the template with its fields filled in."""
    template = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slurm-template.sh")
    with open(template) as f:
        script = f.read()
    for key, value in {
        "JOB_NAME": job_name,
        "NUM_NODES": str(num_nodes),
        "GPUS_PER_NODE": str(gpus_per_node),
        "PARTITION": partition,
        "TIME_LIMIT": time_limit,
        "COMMAND": f"python -m nuzero_tpu_torch {args}".rstrip(),
    }.items():
        script = script.replace("${%s}" % key, value)
    return script


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--job-name", default=None)
    parser.add_argument("--num-nodes", type=int, default=1)
    parser.add_argument("--gpus-per-node", type=int, default=1,
                        help="cards per node; one task runs on each")
    parser.add_argument("--partition", default="batch")
    parser.add_argument("--time-limit", default="24:00:00")
    parser.add_argument("--args", default="",
                        help="the arguments of python -m nuzero_tpu_torch")
    parser.add_argument("--dry-run", action="store_true", help="print the script, don't sbatch")
    args = parser.parse_args(argv)

    job_name = args.job_name or "nuzero-{}".format(time.strftime("%m%d-%H%M%S"))
    script = render(job_name, args.num_nodes, args.gpus_per_node, args.partition,
                    args.time_limit, args.args)
    if args.dry_run:
        print(script)
        return
    with tempfile.NamedTemporaryFile("w", suffix=".sh", delete=False) as f:
        f.write(script)
        path = f.name
    try:
        subprocess.run(["sbatch", path], check=True)
    except FileNotFoundError:
        print("sbatch not found — not on a SLURM cluster?", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
