"""args -> backbone adapter.

Counterpart of ``dyglib_tpu/configs/factory.py`` (the model dispatch of
DyGLib's drivers, train_link_prediction.py:95-127): the same fields from
the same flags, the memory models' time shifts from the train split.
``--compute_dtype`` reaches TGAT, CAWN and DyGFormer, as in the JAX
package; the other models take it and compute in float32.
"""
from __future__ import annotations

import argparse

from ..data.datasets import LinkPredictionData
from ..models import (
    CAWN,
    TCL,
    TGAT,
    DyGFormer,
    GraphMixer,
    MemoryModel,
    compute_src_dst_node_time_shifts,
)


def build_backbone(args: argparse.Namespace, data: LinkPredictionData):
    m = args.model_name
    dtype = getattr(args, "compute_dtype", "float32")
    if m == "TGAT":
        return TGAT(
            num_neighbors=args.num_neighbors,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            sample_strategy=args.sample_neighbor_strategy,
            compute_dtype=dtype,
        )
    if m in ("JODIE", "DyRep", "TGN"):
        shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
        return MemoryModel(
            model_name=m,
            memory_dim=data.node_raw_features.shape[1],
            num_neighbors=args.num_neighbors,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            sample_strategy=args.sample_neighbor_strategy,
            time_shifts=shifts,
        )
    if m == "CAWN":
        return CAWN(
            num_neighbors=args.num_neighbors,
            walk_length=args.walk_length,
            num_walk_heads=args.num_walk_heads,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            position_feat_dim=args.position_feat_dim,
            sample_strategy=args.sample_neighbor_strategy,
            compute_dtype=dtype,
        )
    if m == "TCL":
        return TCL(
            num_neighbors=args.num_neighbors,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            sample_strategy=args.sample_neighbor_strategy,
        )
    if m == "GraphMixer":
        return GraphMixer(
            num_neighbors=args.num_neighbors,
            num_layers=args.num_layers,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            time_gap=args.time_gap,
            sample_strategy=args.sample_neighbor_strategy,
        )
    if m == "DyGFormer":
        return DyGFormer(
            max_input_sequence_length=args.max_input_sequence_length,
            patch_size=args.patch_size,
            channel_embedding_dim=args.channel_embedding_dim,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            dropout=args.dropout,
            time_feat_dim=args.time_feat_dim,
            compute_dtype=dtype,
        )
    raise ValueError(f"Wrong value for model_name {m!r}!")
