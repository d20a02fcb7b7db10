"""The system under test: ``dyglib_tpu_torch`` as a user drives it.

The only module of the benchmark that imports the port. The trainer is
built through the port's own path (``configs/factory.py::build_backbone``,
``train/link_prediction.py::LinkPredictionTrainer`` with
``TrainConfig(scan_epochs=True)``), given the benchmark's stream,
starting parameters and seeds, and driven through its scanned entries:
``train_epoch_scanned`` and ``evaluate(..., scanned=True)``. A random
sample strategy draws its train neighbours from a generator seeded by the
benchmark and each evaluation sweep's from the port's own eval seed,
which ``Program.eval_seed`` reports. A model field that the
configuration leaves out takes the default of the port's own command
line (``configs/args.py``), as it would for a user; ``Program.layouts``
reports the rows the trainer embeds a batch in.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dyglib_tpu_torch.configs.args import get_link_prediction_args
from dyglib_tpu_torch.configs.factory import build_backbone
from dyglib_tpu_torch.data.containers import EdgeStream
from dyglib_tpu_torch.data.datasets import LinkPredictionData
from dyglib_tpu_torch.graph.neg_sampler import NegativeEdgeSampler
from dyglib_tpu_torch.train.link_prediction import LinkPredictionTrainer, TrainConfig
from dyglib_tpu_torch.utils.rng import eval_seed

# every field the factory reads for TGAT, CAWN, TCL, GraphMixer and DyGFormer
MODEL_FIELDS = ("num_neighbors", "num_layers", "num_heads", "dropout", "time_feat_dim",
                "sample_neighbor_strategy", "compute_dtype", "max_input_sequence_length",
                "patch_size", "channel_embedding_dim", "walk_length", "num_walk_heads",
                "position_feat_dim", "time_gap")
TRAIN_FIELDS = ("time_scaling_factor",)
# the salt the val sweep is evaluated with (val / new-node val / test /
# new-node test: 0 / 1 / 2 / 3)
EVAL_SALT = 0


def _stream(s) -> EdgeStream:
    return EdgeStream(src=s.src, dst=s.dst, ts=s.ts, eid=s.eid, label=s.label)


def model_args(cfg: dict) -> argparse.Namespace:
    """The factory's arguments: the port's command-line defaults for
    ``cfg["model"]``, each of ``MODEL_FIELDS`` that ``cfg`` gives set."""
    args = get_link_prediction_args(["--model_name", cfg["model"]])
    for k in MODEL_FIELDS:
        if k in cfg:
            setattr(args, k, cfg[k])
    return args


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
        self.data = data_of(splits)
        tcfg = TrainConfig(batch_size=cfg["batch_size"], learning_rate=cfg["learning_rate"],
                           scan_epochs=True, **{k: cfg[k] for k in TRAIN_FIELDS if k in cfg})
        self.tr = LinkPredictionTrainer(build_backbone(model_args(cfg), self.data), self.data,
                                        tcfg, device=device)
        self.device = self.tr.device
        # the rows a train batch and a random-negative eval batch embed (the
        # trainer's own choice): "dedup", "triple" or "quad"
        self.layouts = {"train": self.tr._layout(), "eval": self.tr._layout(neg_src_is_src=True)}
        # the seed the port re-seeds a val sweep's neighbour draws with
        self.eval_seed = eval_seed(EVAL_SALT)

    # ----------------------------------------------------------- parameters
    def start(self, init_seed: int, make_params, dropout_seed: int, negatives_seed: int,
              sample_seed: int) -> dict:
        """Build the networks, load the parameters ``make_params(shapes)``
        gives, seed dropout, the train negatives and, under a random sample
        strategy, the train neighbour draws. Returns the parameters loaded,
        by name (the head's under ``head.``)."""
        self.tr.init_params(init_seed)
        sd = self.tr.state_dicts()
        shapes = {k: tuple(v.shape) for k, v in sd["backbone"].items()}
        shapes.update({f"head.{k}": tuple(v.shape) for k, v in sd["head"].items()})
        params = make_params(shapes)
        self.tr.load_params({
            "backbone": {k: v for k, v in params.items() if not k.startswith("head.")},
            "head": {k[5:]: v for k, v in params.items() if k.startswith("head.")}})
        self.tr.dropout_gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        if self.tr.sample_gen is not None:
            self.tr.sample_gen = torch.Generator(device=self.device).manual_seed(sample_seed)
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

    def neighbours(self, phase: str, queries, seed: int) -> list:
        """The backbone's own sampler over ``queries`` ((ids, time keys) host
        arrays, one pair a batch) on the train or the whole stream's CSR,
        drawing from a generator on the device seeded with ``seed`` -> per
        batch each hop's (ids, edge ids, time keys, mask) on the host; None
        where the backbone's inputs carry no hop tables. TGAT's hops carry
        their mask; CAWN's hop tables start at the query (edge 0) and carry
        none: their mask is id != 0."""
        csr = self.tr.train_csr if phase == "train" else self.tr.full_csr
        gen = torch.Generator(device=self.device).manual_seed(seed)
        host = lambda hops: [t.cpu().numpy() for t in hops]
        out = []
        for ids, t in queries:
            inp = self.tr.backbone.sample(csr, torch.from_numpy(ids).to(self.device),
                                          torch.from_numpy(t).to(self.device), gen=gen)
            if not all(hasattr(inp, k) for k in ("hop_ids", "hop_eids", "hop_ts")):
                return None
            nid = host(inp.hop_ids[1:])
            hops = len(nid)
            mask = (host(inp.hop_mask) if hasattr(inp, "hop_mask")
                    else [a != 0 for a in nid])
            out.append(list(zip(nid, host(inp.hop_eids[-hops:]), host(inp.hop_ts[1:]), mask)))
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
        losses, _, probs = self.tr.evaluate(self.data.val, self.tr.val_neg, EVAL_SALT,
                                            scanned=True)
        return losses, probs
