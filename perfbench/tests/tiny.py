"""Sizes at which every cell runs on the CPU in seconds, for the tests."""

SOFTMAX = {"config": {"n_train": 300, "dim": 12, "n_classes": 4},
           "traffic": {"chains": 4, "warmup_steps": 30, "chunk_draws": 5, "capture_span": 10,
                       "capture_draws": 2, "trace_skip_chunks": 1, "trace_chunks": 1}}
MLP = {"config": {"n_train": 300, "dim": 12, "hidden": 8, "sgd_init_steps": 20},
       "traffic": {"chains": 4, "batch_size": 16, "chunk_steps": 20, "collect_every": 10,
                   "capture_span": 40, "capture_draws": 2, "trace_skip_chunks": 1,
                   "trace_chunks": 1}}
SIZES = {"softmax-mnist": SOFTMAX, "mlp-dropout-mnist": MLP}


def overrides(bench, cell_name):
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            return SIZES[w["config"]]
    raise KeyError(cell_name)
