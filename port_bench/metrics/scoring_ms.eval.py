"""Host ms a scanned eval sweep spends on per-batch AP/AUC (the eval/scoring span): its durations in the trace over the window's sweeps."""
from port_bench import spans

LAYER = "sweep: train/link_prediction.py train_epoch_scanned and evaluate"
UNIT = "ms"
MOVES = "eval_edges_per_s"
PHASE = "eval"


def read(run):
    return spans.host_ms(run, "scoring")
