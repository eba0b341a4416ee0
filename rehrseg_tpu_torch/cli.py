"""The pipeline's command line: ``python -m rehrseg_tpu_torch.cli --config
configs/brain.yaml --fold 0 [--device cpu]`` (reference
train_all.py:577-583; ``rehrseg_tpu.cli``).

Runs :func:`rehrseg_tpu_torch.pipeline.main` in one process on one card
(or the CPU with ``--device cpu``). ``--fold all`` and the
``REHRSEG_PLATFORM`` / multi-process settings of the JAX command line are
still to be ported (ROADMAP queue 1, item 10b) and raise.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="REHRSeg 3-stage pipeline (PyTorch)")
    parser.add_argument("--config", type=str,
                        default="./configs/brain.yaml")
    parser.add_argument("--fold", type=str, default=None,
                        help="fold index of nnUNet's splits (none: every "
                             "subject trains, no validation)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    fold = args.fold
    if fold == "all" or os.environ.get("REHRSEG_PLATFORM"):
        raise NotImplementedError(
            "--fold all and REHRSEG_PLATFORM (fold-parallel and "
            "multi-process runs) are still to be ported (ROADMAP queue 1, "
            "item 10b)")
    if fold is not None:
        fold = int(fold)
    from .pipeline import main as run_main
    return run_main(args.config, fold=fold, device=args.device)


if __name__ == "__main__":
    main()
