"""Share of the train window in which no operation ran on the device."""
from port_bench import trace

LAYER = "device"
UNIT = "%"
MOVES = "train_edges_per_s"
PHASE = "train"
read = trace.idle_share
