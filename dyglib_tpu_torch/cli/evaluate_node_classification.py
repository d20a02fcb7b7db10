"""CLI: evaluate saved node-classification heads.

    python -m dyglib_tpu_torch.cli.evaluate_node_classification --help
"""
from __future__ import annotations

from ..configs import get_node_classification_args
from ..runners import print_aggregate, run_node_classification_evaluation


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, run, print the aggregate lines; returns the aggregate."""
    args = get_node_classification_args(argv)
    aggregate = run_node_classification_evaluation(args)
    print_aggregate(aggregate)
    return aggregate


if __name__ == "__main__":
    main()
