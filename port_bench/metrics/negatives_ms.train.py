"""Host ms a scanned train sweep spends drawing its negatives (the train/negatives span): its durations in the trace over the window's sweeps."""
from port_bench import spans

LAYER = "sweep: train/link_prediction.py train_epoch_scanned and evaluate"
UNIT = "ms"
MOVES = "train_edges_per_s"
PHASE = "train"


def read(run):
    return spans.host_ms(run, "negatives")
