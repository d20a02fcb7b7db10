"""Device ms a replayed train step spends in train/sample: from its mark to the next (the dyglib_mark_* kernels of the step's replay in the trace)."""
from port_bench import spans

LAYER = "scan path and network: train/step_graph.py, models, nn/modules.py"
UNIT = "ms"
MOVES = "train_edges_per_s"
PHASE = "train"


def read(run):
    return spans.device_ms(run, "sample")
