"""Device kernels a train step launches, counted in the trace of the window; fusions lower it."""
from port_bench import trace

LAYER = "scan path and network: train/step_graph.py, models, nn/modules.py"
UNIT = "kernels/step"
MOVES = "train_edges_per_s"
PHASE = "train"
read = trace.kernels_per_step
