"""The port's four command-line drivers, DyGLib's surface:

    python -m dyglib_tpu_torch.cli.train_link_prediction --model_name TGAT \
        --dataset_name wikipedia --load_best_configs --num_runs 5
    python -m dyglib_tpu_torch.cli.evaluate_link_prediction ... \
        --negative_sample_strategy historical
    python -m dyglib_tpu_torch.cli.train_node_classification ...
    python -m dyglib_tpu_torch.cli.evaluate_node_classification ...

Each runs on the card unless ``--device cpu`` is given, writes its
artifacts under ./saved_models, ./saved_results and ./logs of the working
directory, and prints one "<split> <metric>: mean ± std" line per
aggregate. The kernels build once into ``dyglib_tpu_torch/build/``.
"""
