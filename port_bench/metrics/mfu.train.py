"""The model's products a train step (work/step_<model>.py) over the traced window's time a step and the configuration's peak (67 TF/s float32)."""
from port_bench import trace

LAYER = "device, whole step"
UNIT = "%"
MOVES = "train_edges_per_s"
PHASE = "train"
read = trace.mfu
