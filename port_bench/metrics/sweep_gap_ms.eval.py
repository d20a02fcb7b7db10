"""Device-idle ms a eval sweep spends outside its graph replays: the host's staging, copies, read-back and AP/AUC around them (profiler timeline against the bench/sweep spans)."""
from port_bench import trace

LAYER = "sweep: train/link_prediction.py train_epoch_scanned and evaluate"
UNIT = "ms"
MOVES = "eval_edges_per_s"
PHASE = "eval"
read = trace.sweep_gap_ms
