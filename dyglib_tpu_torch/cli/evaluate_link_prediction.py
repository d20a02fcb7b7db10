"""CLI: evaluate saved link-prediction checkpoints under a
negative-sampling strategy (random, historical or inductive), EdgeBank included.

    python -m dyglib_tpu_torch.cli.evaluate_link_prediction --help
"""
from __future__ import annotations

from ..configs import get_link_prediction_args
from ..runners import print_aggregate, run_link_prediction_evaluation


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, run, print the aggregate lines; returns the aggregate."""
    args = get_link_prediction_args(argv, is_evaluation=True)
    aggregate = run_link_prediction_evaluation(args)
    print_aggregate(aggregate)
    return aggregate


if __name__ == "__main__":
    main()
