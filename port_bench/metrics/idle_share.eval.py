"""Share of the eval window in which no operation ran on the device."""
from port_bench import trace

LAYER = "device"
UNIT = "%"
MOVES = "eval_edges_per_s"
PHASE = "eval"
read = trace.idle_share
