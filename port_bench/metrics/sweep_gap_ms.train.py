"""Device-idle ms a train sweep spends outside its graph replays: the host's staging, copies, read-back and AP/AUC around them (profiler timeline against the bench/sweep spans)."""
from port_bench import trace

LAYER = "sweep: train/link_prediction.py train_epoch_scanned and evaluate"
UNIT = "ms"
MOVES = "train_edges_per_s"
PHASE = "train"
read = trace.sweep_gap_ms
