#!/bin/bash
# SLURM template for data-parallel runs of the PyTorch port (counterpart of
# slurm/slurm-template.sh): ONE task per card, where the JAX package runs
# one per host.  Every task joins the process group from SLURM_PROCID,
# SLURM_NTASKS and SLURM_LOCALID, with JAX_COORDINATOR as its rendezvous,
# and takes the card cuda:SLURM_LOCALID (nuzero_tpu_torch/parallel/distributed.py).
#
# Rendered by nuzero_tpu_torch/slurm/launch.py: ${JOB_NAME} ${NUM_NODES}
# ${GPUS_PER_NODE} ${PARTITION} ${TIME_LIMIT} ${COMMAND} are substituted.

#SBATCH --job-name=${JOB_NAME}
#SBATCH --nodes=${NUM_NODES}
#SBATCH --ntasks-per-node=${GPUS_PER_NODE}
#SBATCH --gpus-per-node=${GPUS_PER_NODE}
#SBATCH --exclusive
#SBATCH --partition=${PARTITION}
#SBATCH --time=${TIME_LIMIT}
#SBATCH --output=${JOB_NAME}-%j.out

head_node=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export JAX_COORDINATOR="${head_node}:8476"

srun --kill-on-bad-exit=1 ${COMMAND}
