"""Host ms a scanned train sweep spends stacking its batches' arrays and copying them to the device (the train/staging span): its durations in the trace over the window's sweeps."""
from port_bench import spans

LAYER = "sweep: train/link_prediction.py train_epoch_scanned and evaluate"
UNIT = "ms"
MOVES = "train_edges_per_s"
PHASE = "train"


def read(run):
    return spans.host_ms(run, "staging")
