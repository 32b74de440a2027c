#!/bin/bash
# SeFlow++ SSL training on the GPUs of one host — the equivalent of the
# reference's 4-GPU slurm recipe (assets/slurm/ssl-train-av2.sh): data
# parallelism comes from the jit-sharded batch over the mesh 'data' axis, so
# no DDP launcher is needed — one process drives every GPU.
#
# Usage: bash assets/launch/train-av2.sh /path/to/av2/h5
set -euo pipefail
DATA_DIR=${1:?usage: train-av2.sh DATA_DIR [RUN_DIR]}
RUN_DIR=${2:-runs/seflowpp-av2}

# 1) SSL pseudo-labels (once per dataset).
python -m himo_tpu.cli.ssl_label dataset_path="$DATA_DIR"

# 2) Train: reference recipe (batch 8, 12 epochs, lr 6e-5, StepLR(3, 0.5)).
python -m himo_tpu.cli.train \
    dataset_path="$DATA_DIR" \
    model=seflowpp \
    batch_size=8 epochs=12 lr=6e-5 \
    num_points=65536 \
    run_dir="$RUN_DIR" \
    wandb_mode=disabled

# 3) Write flow fields back into the scenes with the best checkpoint.
python -m himo_tpu.cli.save \
    model=seflowpp \
    checkpoint="$RUN_DIR/ckpts" \
    dataset_path="$DATA_DIR" \
    output_key=seflowpp_best
