"""The pipeline's command line: ``python -m rehrseg_tpu_torch.cli --config
configs/brain.yaml --fold 0 [--device cpu]`` (reference
train_all.py:577-583; ``rehrseg_tpu.cli``).

Runs :func:`rehrseg_tpu_torch.pipeline.main` on the card (or the CPU with
``--device cpu`` or ``REHRSEG_PLATFORM=cpu``). ``--fold all`` trains every
fold's stage 2 side by side, one fold per card. Several processes, one per
card, train data-parallel::

    torchrun --nproc-per-node N -m rehrseg_tpu_torch.cli --config CFG --fold 0

(or ``REHRSEG_COORDINATOR`` / ``REHRSEG_NUM_PROCESSES`` /
``REHRSEG_PROCESS_ID`` per process, as for the JAX package); the process
group forms before any CUDA work, over NCCL on the cards and gloo under
``REHRSEG_PLATFORM=cpu``. With ``extra.mesh_spatial: S`` each process
drives S cards (cards ``LOCAL_RANK * S .. + S - 1``), its stage-2 patches'
H sharded over them, so torchrun starts cards / S processes a node.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="REHRSeg 3-stage pipeline (PyTorch)")
    parser.add_argument("--config", type=str,
                        default="./configs/brain.yaml")
    parser.add_argument("--fold", type=str, default=None,
                        help="fold index of nnUNet's splits (none: every "
                             "subject trains, no validation), or 'all' to "
                             "train every fold at once, one per card")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; "
                             "REHRSEG_PLATFORM=cpu also selects the CPU)")
    args = parser.parse_args(argv)
    fold = args.fold
    if fold is not None and fold != "all":
        fold = int(fold)

    # before any CUDA work: the process group (no-op for one process) and
    # the check that a multi-process environment really formed one
    from .config import load_config
    from .parallel.distributed import (assert_pod_consistency,
                                       cpu_requested, init_distributed)
    spatial = int((load_config(args.config).extra or {}).get(
        "mesh_spatial", 1) or 1)
    init_distributed(cards_per_process=spatial)
    assert_pod_consistency()
    device = args.device
    if device is None and cpu_requested():
        device = "cpu"
    from .pipeline import main as run_main
    return run_main(args.config, fold=fold, device=device)


if __name__ == "__main__":
    main()
