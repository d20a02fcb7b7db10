"""Per-(model, dataset) grid-search winners of DyGLib's published runs.

A copy of ``dyglib_tpu/configs/best_configs.py`` (the port imports
nothing of the JAX package): tables of data, transcribed from DyGLib's
utils/load_configs.py:69-236 (link prediction) and :292-347 (node
classification). They define the published operating points, e.g.
DyGFormer wikipedia = (max_seq_len 32, patch 1), reddit (64, 2), lastfm
(512, 16), CanParl (2048, 64).
"""
from __future__ import annotations

import argparse


def load_link_prediction_best_configs(args: argparse.Namespace) -> None:
    """Mutates ``args`` in place (load_configs.py:69-236)."""
    d = args.dataset_name
    m = args.model_name
    if m == "TGAT":
        args.num_neighbors = 20
        args.num_layers = 2
        args.dropout = 0.2 if d in ("enron", "CanParl", "UNvote") else 0.1
        args.sample_neighbor_strategy = (
            "uniform" if d in ("reddit", "CanParl", "UNtrade") else "recent"
        )
    elif m in ("JODIE", "DyRep", "TGN"):
        args.num_neighbors = 10
        args.num_layers = 1
        if m == "JODIE":
            if d in ("mooc", "USLegis"):
                args.dropout = 0.2
            elif d == "lastfm":
                args.dropout = 0.3
            elif d in ("uci", "UNtrade"):
                args.dropout = 0.4
            elif d == "CanParl":
                args.dropout = 0.0
            else:
                args.dropout = 0.1
        elif m == "DyRep":
            args.dropout = 0.0 if d in (
                "mooc", "lastfm", "enron", "uci", "CanParl", "USLegis", "Contacts"
            ) else 0.1
        else:  # TGN
            if d in ("mooc", "UNtrade"):
                args.dropout = 0.2
            elif d in ("lastfm", "CanParl"):
                args.dropout = 0.3
            elif d in ("enron", "SocialEvo"):
                args.dropout = 0.0
            else:
                args.dropout = 0.1
        if m in ("TGN", "DyRep"):
            args.sample_neighbor_strategy = (
                "uniform"
                if d == "CanParl" or (m == "TGN" and d == "UNvote")
                else "recent"
            )
    elif m == "CAWN":
        args.time_scaling_factor = 1e-6
        if d in ("mooc", "SocialEvo", "uci", "Flights", "UNtrade", "UNvote", "Contacts"):
            args.num_neighbors = 64
        elif d in ("lastfm", "CanParl"):
            args.num_neighbors = 128
        else:
            args.num_neighbors = 32
        args.dropout = 0.0 if d == "CanParl" else 0.1
        args.sample_neighbor_strategy = "time_interval_aware"
    elif m == "EdgeBank":
        s = args.negative_sample_strategy
        if s == "random":
            if d in ("wikipedia", "reddit", "uci", "Flights"):
                args.edge_bank_memory_mode = "unlimited_memory"
            elif d in ("mooc", "lastfm", "enron", "CanParl", "USLegis"):
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "fixed_proportion"
            elif d in ("UNtrade", "UNvote", "Contacts"):
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "repeat_interval"
            else:
                args.edge_bank_memory_mode = "repeat_threshold_memory"
        elif s == "historical":
            if d in ("uci", "CanParl", "USLegis"):
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "fixed_proportion"
            elif d in ("mooc", "lastfm", "enron", "UNtrade", "UNvote", "Contacts"):
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "repeat_interval"
            else:
                args.edge_bank_memory_mode = "repeat_threshold_memory"
        else:  # inductive
            if d == "USLegis":
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "fixed_proportion"
            elif d in ("uci", "UNvote"):
                args.edge_bank_memory_mode = "time_window_memory"
                args.time_window_mode = "repeat_interval"
            else:
                args.edge_bank_memory_mode = "repeat_threshold_memory"
    elif m == "TCL":
        args.num_neighbors = 20
        args.num_layers = 2
        if d in ("SocialEvo", "uci", "UNtrade", "UNvote", "Contacts"):
            args.dropout = 0.0
        elif d == "CanParl":
            args.dropout = 0.2
        elif d == "USLegis":
            args.dropout = 0.3
        else:
            args.dropout = 0.1
        args.sample_neighbor_strategy = (
            "uniform"
            if d in ("reddit", "CanParl", "USLegis", "UNtrade", "UNvote")
            else "recent"
        )
    elif m == "GraphMixer":
        args.num_layers = 2
        if d == "wikipedia":
            args.num_neighbors = 30
        elif d in ("reddit", "lastfm"):
            args.num_neighbors = 10
        else:
            args.num_neighbors = 20
        if d in ("wikipedia", "reddit", "enron"):
            args.dropout = 0.5
        elif d in ("mooc", "uci", "USLegis"):
            args.dropout = 0.4
        elif d in ("lastfm", "UNvote"):
            args.dropout = 0.0
        elif d == "SocialEvo":
            args.dropout = 0.3
        elif d in ("Flights", "CanParl"):
            args.dropout = 0.2
        else:
            args.dropout = 0.1
        args.sample_neighbor_strategy = (
            "uniform" if d in ("CanParl", "UNtrade", "UNvote") else "recent"
        )
    elif m == "DyGFormer":
        args.num_layers = 2
        if d == "reddit":
            args.max_input_sequence_length, args.patch_size = 64, 2
        elif d in ("mooc", "enron", "Flights", "USLegis", "UNtrade"):
            args.max_input_sequence_length, args.patch_size = 256, 8
        elif d == "lastfm":
            args.max_input_sequence_length, args.patch_size = 512, 16
        elif d == "CanParl":
            args.max_input_sequence_length, args.patch_size = 2048, 64
        elif d == "UNvote":
            args.max_input_sequence_length, args.patch_size = 128, 4
        else:
            args.max_input_sequence_length, args.patch_size = 32, 1
        assert args.max_input_sequence_length % args.patch_size == 0
        if d in ("reddit", "UNvote"):
            args.dropout = 0.2
        elif d in ("enron", "USLegis", "UNtrade", "Contacts"):
            args.dropout = 0.0
        else:
            args.dropout = 0.1
    else:
        raise ValueError(f"Wrong value for model_name {m!r}!")


def load_node_classification_best_configs(args: argparse.Namespace) -> None:
    """Mutates ``args`` in place (load_configs.py:292-347)."""
    d = args.dataset_name
    m = args.model_name
    if m == "TGAT":
        args.num_neighbors = 20
        args.num_layers = 2
        args.dropout = 0.1
        args.sample_neighbor_strategy = "uniform" if d == "reddit" else "recent"
    elif m in ("JODIE", "DyRep", "TGN"):
        args.num_neighbors = 10
        args.num_layers = 1
        args.dropout = 0.1
        args.sample_neighbor_strategy = "recent"
    elif m == "CAWN":
        args.time_scaling_factor = 1e-6
        args.num_neighbors = 32
        args.dropout = 0.1
        args.sample_neighbor_strategy = "time_interval_aware"
    elif m == "TCL":
        args.num_neighbors = 20
        args.num_layers = 2
        args.dropout = 0.1
        args.sample_neighbor_strategy = "uniform" if d == "reddit" else "recent"
    elif m == "GraphMixer":
        args.num_layers = 2
        args.num_neighbors = 10 if d == "reddit" else 30
        args.dropout = 0.5
        args.sample_neighbor_strategy = "recent"
    elif m == "DyGFormer":
        args.num_layers = 2
        if d == "reddit":
            args.max_input_sequence_length, args.patch_size = 64, 2
            args.dropout = 0.2
        else:
            args.max_input_sequence_length, args.patch_size = 32, 1
            args.dropout = 0.1
        assert args.max_input_sequence_length % args.patch_size == 0
    else:
        raise ValueError(f"Wrong value for model_name {m!r}!")
