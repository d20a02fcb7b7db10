"""CLI: train a dynamic-graph model for link prediction.

    python -m dyglib_tpu_torch.cli.train_link_prediction --help
"""
from __future__ import annotations

from ..configs import get_link_prediction_args
from ..runners import print_aggregate, run_link_prediction_training


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, run, print the aggregate lines; returns the aggregate."""
    args = get_link_prediction_args(argv, is_evaluation=False)
    aggregate = run_link_prediction_training(args)
    print_aggregate(aggregate)
    return aggregate


if __name__ == "__main__":
    main()
