#!/bin/bash
# Batch-job wrapper for the source-detection CLI of the PyTorch port
# (caesar_mrcnn_tpu_torch), the counterpart of scripts/run_caesar_tpu.sh.
#
# Role parity with the reference's container wrapper
# (reference: scripts/run_mrcnn.sh): translate kebab-case batch flags to the
# CLI's flags, run inside a job dir, and copy artifacts to an output dir.
#
# It runs on the card (the CLI's --device cuda) unless --device=cpu is given.
#
# Usage: run_caesar_torch.sh --runmode=detect --image=/path/img.fits \
#          [--weights=/path/ckpt.pt] [--device=cuda|cpu] [--job-dir=DIR] [--output-dir=DIR] [extra args...]

set -euo pipefail

RUNMODE=""
JOB_DIR="$(pwd)"
OUTPUT_DIR=""
EXTRA_ARGS=()

for arg in "$@"; do
  case "$arg" in
    --runmode=*)      RUNMODE="${arg#*=}" ;;
    --job-dir=*)      JOB_DIR="${arg#*=}" ;;
    --output-dir=*)   OUTPUT_DIR="${arg#*=}" ;;
    --datalist=*)     EXTRA_ARGS+=("--datalist" "${arg#*=}") ;;
    --datadir=*)      EXTRA_ARGS+=("--datadir" "${arg#*=}") ;;
    --dataloader=*)   EXTRA_ARGS+=("--dataloader" "${arg#*=}") ;;
    --image=*)        EXTRA_ARGS+=("--image" "${arg#*=}") ;;
    --weights=*)      EXTRA_ARGS+=("--weights" "${arg#*=}") ;;
    --nepochs=*)      EXTRA_ARGS+=("--nepochs" "${arg#*=}") ;;
    --ngpu=*)         EXTRA_ARGS+=("--ngpu" "${arg#*=}") ;;
    --nimg-per-gpu=*) EXTRA_ARGS+=("--nimg_per_gpu" "${arg#*=}") ;;
    --imgsize=*)      EXTRA_ARGS+=("--imgsize" "${arg#*=}") ;;
    --score-thr=*)    EXTRA_ARGS+=("--scoreThr" "${arg#*=}") ;;
    --iou-thr=*)      EXTRA_ARGS+=("--iouThr" "${arg#*=}") ;;
    --split-img-in-tiles) EXTRA_ARGS+=("--split_img_in_tiles") ;;
    --tile-xsize=*)   EXTRA_ARGS+=("--tile_xsize" "${arg#*=}") ;;
    --tile-ysize=*)   EXTRA_ARGS+=("--tile_ysize" "${arg#*=}") ;;
    --device=*)       EXTRA_ARGS+=("--device" "${arg#*=}") ;;
    *)                EXTRA_ARGS+=("$arg") ;;
  esac
done

if [[ -z "$RUNMODE" ]]; then
  echo "ERROR: --runmode={train,test,detect} is required" >&2
  exit 1
fi

mkdir -p "$JOB_DIR"
cd "$JOB_DIR"

python -m caesar_mrcnn_tpu_torch.cli.run "$RUNMODE" "${EXTRA_ARGS[@]}"

if [[ -n "$OUTPUT_DIR" ]]; then
  mkdir -p "$OUTPUT_DIR"
  # copy result artifacts (catalogs, regions, tables, plots, checkpoints)
  find . -maxdepth 2 \
    \( -name '*.json' -o -name '*.reg' -o -name '*.csv' -o -name '*.png' \) \
    -newer /proc/$$/stat -exec cp --parents {} "$OUTPUT_DIR/" \; 2>/dev/null || true
  if [[ -d logs ]]; then cp -r logs "$OUTPUT_DIR/" || true; fi
fi
