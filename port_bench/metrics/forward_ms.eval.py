"""Device ms a replayed eval step spends in eval/forward and eval/head: from the forward mark to the step's end mark (the dyglib_mark_* kernels of the step's replay in the trace)."""
from port_bench import spans

LAYER = "scan path and network: train/step_graph.py, models, nn/modules.py"
UNIT = "ms"
MOVES = "eval_edges_per_s"
PHASE = "eval"


def read(run):
    return spans.device_ms(run, "forward", "head")
