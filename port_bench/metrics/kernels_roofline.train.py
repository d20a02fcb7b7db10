"""The port's kernel functions in a train step: their least time (bytes at 3.35 TB/s or products at 165 T/s, work from work/) over their device time in the trace."""
from port_bench import trace

LAYER = "kernels: ops and csrc"
UNIT = "%"
MOVES = "train_edges_per_s"
PHASE = "train"
read = trace.kernels_roofline
