"""The system under test: ``dyglib_tpu_torch`` as a user drives it.

The only module of the benchmark that imports the port. The trainer is
built through the port's own path (``configs/factory.py::build_backbone``,
``train/link_prediction.py::LinkPredictionTrainer`` with
``TrainConfig(scan_epochs=True)``), given the benchmark's stream,
starting parameters and seeds, and driven through its scanned entries:
``train_epoch_scanned`` and ``evaluate(..., scanned=True)``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dyglib_tpu_torch.configs.factory import build_backbone
from dyglib_tpu_torch.data.containers import EdgeStream
from dyglib_tpu_torch.data.datasets import LinkPredictionData
from dyglib_tpu_torch.graph.neg_sampler import NegativeEdgeSampler
from dyglib_tpu_torch.train.link_prediction import LinkPredictionTrainer, TrainConfig

MODEL_FIELDS = ("num_neighbors", "num_layers", "num_heads", "dropout", "time_feat_dim",
                "sample_neighbor_strategy", "compute_dtype", "max_input_sequence_length",
                "patch_size", "channel_embedding_dim")


def _stream(s) -> EdgeStream:
    return EdgeStream(src=s.src, dst=s.dst, ts=s.ts, eid=s.eid, label=s.label)


def data_of(splits) -> LinkPredictionData:
    return LinkPredictionData(
        node_raw_features=splits.node_feats, edge_raw_features=splits.edge_feats,
        full=_stream(splits.full), train=_stream(splits.train), val=_stream(splits.val),
        test=_stream(splits.test), new_node_val=_stream(splits.new_node_val),
        new_node_test=_stream(splits.new_node_test))


class Program:
    """One trainer of the port on one device."""

    def __init__(self, cfg: dict, splits, device):
        self.splits = splits
        args = argparse.Namespace(model_name=cfg["model"],
                                  **{k: cfg[k] for k in MODEL_FIELDS if k in cfg})
        self.data = data_of(splits)
        tcfg = TrainConfig(batch_size=cfg["batch_size"], learning_rate=cfg["learning_rate"],
                           scan_epochs=True)
        self.tr = LinkPredictionTrainer(build_backbone(args, self.data), self.data, tcfg,
                                        device=device)
        self.device = self.tr.device

    # ----------------------------------------------------------- parameters
    def start(self, init_seed: int, make_params, dropout_seed: int, negatives_seed: int) -> dict:
        """Build the networks, load the parameters ``make_params(shapes)``
        gives, seed dropout and the train negatives. Returns the
        parameters loaded, by name (the head's under ``head.``)."""
        self.tr.init_params(init_seed)
        sd = self.tr.state_dicts()
        shapes = {k: tuple(v.shape) for k, v in sd["backbone"].items()}
        shapes.update({f"head.{k}": tuple(v.shape) for k, v in sd["head"].items()})
        params = make_params(shapes)
        self.tr.load_params({
            "backbone": {k: v for k, v in params.items() if not k.startswith("head.")},
            "head": {k[5:]: v for k, v in params.items() if k.startswith("head.")}})
        self.tr.dropout_gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        train = self.data.train
        self.tr.train_neg = NegativeEdgeSampler(train.src, train.dst, seed=negatives_seed)
        return params

    def _named(self):
        for prefix, mod in (("", self.tr.model), ("head.", self.tr.head)):
            for k, p in mod.named_parameters():
                yield prefix + k, p

    def parameters(self) -> dict:
        return {k: p.detach().to("cpu", copy=True) for k, p in self._named()}

    def first_gradients(self) -> dict:
        """The first step's gradients as Adam received them: its first
        moment after one step over (1 - beta1)."""
        opt = self.tr.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in self._named():
            st = opt.state.get(p, {})
            m = st.get("exp_avg")
            out[k] = (torch.zeros_like(p) if m is None else m / (1.0 - beta1)).to("cpu")
        return out

    # --------------------------------------------------------------- sweeps
    def train_sweep(self, rows: np.ndarray) -> list[float]:
        """``train_epoch_scanned`` over the train edges ``rows`` -> its losses."""
        t = self.splits.train
        sub = EdgeStream(src=t.src[rows], dst=t.dst[rows], ts=t.ts[rows], eid=t.eid[rows],
                         label=t.label[rows])
        return self.tr.train_epoch_scanned(stream=sub)[0]

    def eval_sweep(self):
        """``evaluate`` over the val split with its random negatives,
        scanned -> (losses, probabilities) per batch."""
        losses, _, probs = self.tr.evaluate(self.data.val, self.tr.val_neg, scanned=True)
        return losses, probs
