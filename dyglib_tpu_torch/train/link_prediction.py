"""Dynamic link prediction: training and evaluation loops.

Counterpart of ``dyglib_tpu/train/link_prediction.py`` for every
parametric model the JAX package has (DyGFormer, TGAT, TGN, DyRep, JODIE,
GraphMixer, TCL, CAWN): ``TrainConfig``, ``make_optimizer``, the train
step, ``train_epoch``, ``train_epoch_scanned``, ``evaluate`` and ``fit``
with its mid-epoch resume checkpoints, TensorBoard scalars and profiler
hook.

Protocol (the JAX package's):
  * chronological batches, never shuffled, the last one padded and masked;
  * train negatives: only destinations are drawn (unseeded sampler),
    neg_src = src; the loss is the masked mean BCE over positives and
    negatives, on logits;
  * eval negatives: the eval samplers' seeded streams are reset before
    every sweep; under the random strategy the sampler's neg_src draw is
    made and discarded (the negative edge is (src, neg_dst)); under the
    historical and inductive strategies the drawn pair is the negative
    edge, drawn from the batch's edges and time range;
  * the rows a batch embeds (``_layout``), as the JAX trainer picks them:
    where neg_src = src (training, random eval), a pair-independent
    backbone (TGAT, GraphMixer, the memory models) embeds the triple
    [src || dst || neg_dst] and reuses src's rows for neg_src ("dedup"),
    and a stateless pair-aware one with ``triple_expand`` under ``recent``
    (DyGFormer, TCL) pairs the triple's rows itself ("triple"); every other
    case embeds the quad [src || dst || neg_src || neg_dst] ("quad"): the
    historical and inductive negatives, CAWN (its position counts pair row
    q with q +- B) and TCL under ``uniform`` (neg_src's draws are not
    src's);
  * training samples histories from train_csr, evaluation from full_csr;
    the trainer builds ``csr.feat_prefix`` for a backbone that
    ``wants_feat_prefix`` (GraphMixer, under a 2 GB budget) and
    ``csr.tia_cew`` (with ``cfg.time_scaling_factor``) for the
    ``time_interval_aware`` strategy;
  * a backbone with a stochastic sample strategy (``uniform``,
    ``time_interval_aware``) draws from the trainer's ``sample_gen`` in
    training (seeded by ``init_params``) and, in each ``evaluate``, from a
    generator seeded afresh from 12345 + ``eval_key_salt`` (val / new-node
    val / test / new-node test: 0 / 1 / 2 / 3), as the JAX package seeds
    its key: two sweeps give the same probabilities. Draws differ from
    JAX's bits;
  * with a backbone that publishes sequence buckets (DyGFormer), each
    batch runs at the smallest bucket covering its longest strictly-before
    history; metrics are per batch, averaged over batches;
  * early stopping when no validation metric improves (ties count as
    improvement) for ``patience`` epochs, then the best checkpoint is
    reloaded for the final val / new-node val / test / new-node test sweeps;
  * a backbone with state (``has_state``: the memory models) gets its
    memory as an explicit ``MemoryState``: ``train_step`` and ``eval_step``
    take it as ``state`` and return the state after committing the batch's
    positive edges as a third element, ``train_epoch`` and ``evaluate``
    (from an empty memory unless ``state`` is given) the final state as an
    extra last element; stateless callers unpack what they did before. The
    layout's roles ("src", "dst", "dst") or ("src", "dst", "src", "dst")
    go on its inputs (JODIE's time normalization is per role). A train step
    commits outside autograd, on the raw (not DyRep-swapped) embeddings,
    with the parameters from before the optimizer's step. ``fit`` starts every epoch from an empty memory;
    val and new-node val run from the state after training, test (every
    ``test_interval_epochs``) from the state after val; the best checkpoint
    holds the parameters and that post-val state, and the final test and
    new-node test sweeps run from it; the validate metrics reported are the
    last epoch's (no final val sweep, whose memory has already seen val);
    ``results["state"]`` is the checkpoint's state;
  * scan epochs (``cfg.scan_epochs``, the JAX ``lax.scan`` programs): a
    train epoch's negatives are drawn first, in the per-batch order, its
    batches staged on the device at once, and every step after the first
    replayed as a CUDA graph (``step_graph.StepGraphs``; on the CPU the
    same staged loop runs eagerly) at the full sequence length (no bucket);
    ``evaluate`` scans likewise when ``cfg.scan_epochs`` and the backbone
    has no sequence buckets (the JAX rule), its graphs kept per layout and
    CSR; losses and probabilities are read back once a sweep. ``fit`` scans
    an epoch unless it resumes mid-epoch or writes resume checkpoints;
  * a rank grid (``mesh=``, ``parallel.make_mesh``; one process a
    device): every rank holds the global batch (the same seeded train
    negatives, and a stochastic strategy's draws made for the whole
    batch) and embeds its rows of it; the loss divides by the global
    batch's valid rows, the gradients are summed over all ranks (the
    model axis's ranks each backpropagating 1/mp of the loss), the
    probabilities gathered, so every rank reports the global numbers;
    only the lead rank (0) writes checkpoints, the others keep theirs in
    memory; a memory model's state is node-sharded (``load_state`` and
    ``host_state`` convert a whole state);
  * mid-epoch resume: every ``cfg.resume_every_batches`` train batches
    ``<save_path>.resume`` records the parameters, the optimizer's state,
    the memory, the epoch and next batch, early stopping's progress and
    the dropout and sampling generators' states (the JAX package folds its
    keys from (epoch, batch) instead); ``fit(resume=True)`` restarts there,
    the skipped batches still drawing their negatives.

Each train step's phases are ``torch.profiler`` ranges (``train/sample``,
``train/forward``, ``train/backward``, ``train/commit`` for a memory
model, ``train/optimizer``) and each eval batch's too (``eval/staging``,
``eval/sample``, ``eval/forward``, ``eval/head``, ``eval/commit``,
``eval/metrics``), so a profiler trace of the real loops breaks their time
down (``scripts/profile_torch_eval.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..data.batching import Batch, chronological_batches
from ..data.containers import EdgeStream
from ..data.datasets import LinkPredictionData
from ..device import resolve_device
from ..graph.csr import FEAT_ENTRY_PAD, TemporalCSR, build_temporal_csr, time_keys
from ..graph.neg_sampler import NegativeEdgeSampler, build_eval_neg_samplers
from ..models.base import FeatureTables
from ..models.memory_model import (
    gather_state,
    memory_order_violations,
    segment_roles,
    shard_state,
    state_rows,
)
from ..nn.modules import MergeLayer
from ..parallel.mesh import (
    DATA_AXIS,
    ColumnShardedTable,
    Mesh,
    all_reduce,
    batch_sharded,
    gather_rows,
    replicated,
    row_slice,
)
from ..utils.rng import generator
from ..utils.tensorboard import SummaryWriter
from .checkpoints import load_checkpoint, save_checkpoint, to_cpu, to_device
from .early_stopping import EarlyStopping
from .metrics import link_prediction_metrics
from .step_graph import StepGraphs, eval_generator, stack_columns

# the JAX package's byte budget for the entry-ordered feature table (and
# for GraphMixer's feature prefix table)
ENTRY_TABLE_BUDGET = 2_000_000_000


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 200
    num_epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"
    patience: int = 20
    test_interval_epochs: int = 10
    # CAWN's time_interval_aware logits: exp(time_scaling_factor * dt)
    time_scaling_factor: float = 1e-6
    # per-batch sequence-length bucketing for backbones that publish
    # bucket_candidates (DyGFormer)
    sequence_buckets: bool = True
    # after every train step, check that no node's memory clock moved
    # backwards (memory models; costs a copy of the clocks to the host a step)
    check_memory_order: bool = False
    # MLPClassifier's dropout (node classification)
    head_dropout: float = 0.1
    # a live per-batch train-loss line on stderr (train_epoch; not in scan
    # mode)
    show_progress: bool = False
    # each train epoch and eval sweep staged at once and replayed step by
    # step as CUDA graphs (the JAX package's lax.scan programs)
    scan_epochs: bool = False
    # > 0: write <save_path>.resume every that many train batches
    resume_every_batches: int = 0
    # non-empty: a torch.profiler trace of the second epoch, into this directory
    profile_dir: str = ""
    # non-empty: one TensorBoard scalar record per epoch, into this directory
    tensorboard_dir: str = ""


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop's update rule: nu = decay * nu + (1 - decay) * g**2,
    p -= lr * g / sqrt(nu + eps), nu starting at 0.

    torch.optim.RMSprop is another rule (alpha 0.99 by default, eps outside
    the square root), so the JAX package's rmsprop is written out here.
    """

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam / SGD / RMSprop with the JAX package's update rules.

    The JAX package builds Adam's weight decay as optax's
    add_decayed_weights before scale_by_adam: the decay is added to the
    gradient, which is torch.optim.Adam's own (coupled) weight_decay. In
    scan mode on a card Adam keeps its step count on the device
    (``capturable``), so that a CUDA graph can replay its step.
    """
    if cfg.optimizer == "adam":
        capturable = cfg.scan_epochs and all(p.is_cuda for p in params)
        return torch.optim.Adam(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
                                capturable=capturable)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    if cfg.optimizer == "rmsprop":
        return OptaxRMSprop(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


class LinkPredictionTrainer:
    """Owns the feature tables, the CSRs, the negative samplers, the
    backbone + MergeLayer head, the optimizer and the dropout and sampling
    generators for one dataset on one device."""

    def __init__(
        self,
        backbone,
        data: LinkPredictionData,
        cfg: TrainConfig,
        save_path: str | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        """``mesh`` (``parallel.make_mesh``; every rank builds its trainer
        with the same arguments): each step runs over the rank grid. Every
        rank holds the global batch and embeds its rows of it
        (``parallel.row_slice``); the loss is the global masked mean,
        gradients are summed over the ranks, probabilities gathered over the
        data axis; feature tables are column-sharded over the model axis
        when it has more than one rank (``ColumnShardedTable``), a memory
        model's state node-sharded over the data axis, and a DyGFormer with
        ``sequence_axis`` shards its joint tokens (Ulysses). ``device``
        defaults to the mesh's."""
        self.backbone = backbone
        self.data = data
        self.cfg = cfg
        self.save_path = save_path
        self.mesh = mesh
        self.is_lead = mesh is None or mesh.rank == 0
        self.has_state = getattr(backbone, "has_state", False)
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        dev = self.device
        if mesh is not None and mesh.model_size > 1:
            self.tables = FeatureTables(
                node=ColumnShardedTable(data.node_raw_features, mesh, "features/node", dev),
                edge=ColumnShardedTable(data.edge_raw_features, mesh, "features/edge", dev),
            )
        else:
            self.tables = FeatureTables(
                node=torch.from_numpy(data.node_raw_features).to(dev),
                edge=torch.from_numpy(data.edge_raw_features).to(dev),
            )
        axis = getattr(backbone, "sequence_axis", None)
        if mesh is not None and axis is not None and backbone.num_heads % mesh.size(axis):
            raise ValueError(f"sequence axis {axis!r} of {mesh.size(axis)} ranks does not "
                             f"divide num_heads {backbone.num_heads}")
        # the entry-ordered feature table, for backbones that fetch their
        # windows from it, under the JAX package's byte budget; its guard
        # pads cover the backbone's longest window
        csr_kw = {}
        if getattr(backbone, "wants_entry_features", False) and (
            getattr(backbone, "sample_strategy", "recent") == "recent"
        ):
            width = data.node_raw_features.shape[1] + data.edge_raw_features.shape[1]
            if 2 * data.full.num_interactions * width * 4 <= ENTRY_TABLE_BUDGET:
                csr_kw = dict(
                    feat_entry_of=(data.node_raw_features, data.edge_raw_features),
                    feat_entry_pad=max(FEAT_ENTRY_PAD, backbone.entry_window_rows),
                )
        # GraphMixer's per-segment feature prefix sums, under the same budget
        prefix_bytes = 2 * data.full.num_interactions * data.node_raw_features.shape[1] * 4
        if getattr(backbone, "wants_feat_prefix", False) and prefix_bytes <= ENTRY_TABLE_BUDGET:
            csr_kw["feat_prefix_of"] = data.node_raw_features
        if getattr(backbone, "sample_strategy", "recent") == "time_interval_aware":
            csr_kw.update(with_tia=True, time_scaling_factor=cfg.time_scaling_factor)
        # training samples histories from train_csr; evaluation reads full_csr
        self.train_csr = build_temporal_csr(
            data.train, num_nodes=data.num_nodes, device=dev, **csr_kw
        )
        self.full_csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev, **csr_kw)
        # negative samplers with the reference's seeds: train unseeded,
        # val / new-node val / test / new-node test = 0 / 1 / 2 / 3 (random;
        # build_eval_neg_samplers gives the other strategies' samplers)
        self.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst)
        if mesh is not None:  # every rank draws the same global negatives
            seed = torch.tensor([np.random.SeedSequence().entropy % 2**32], device=dev)
            seed = int(replicated(seed, mesh, "init/train_negatives_seed"))
            self.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=seed)
        self.val_neg, self.nn_val_neg, self.test_neg, self.nn_test_neg = (
            build_eval_neg_samplers(data))
        # sequence buckets, for backbones that publish them: smallest static
        # length covering a batch's histories
        cands = getattr(backbone, "bucket_candidates", ()) if cfg.sequence_buckets else ()
        self._buckets: tuple[int, ...] | None = tuple(cands) if len(cands) > 1 else None
        self._host_hist: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}
        self.model: torch.nn.Module | None = None
        self.head: MergeLayer | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.dropout_gen: torch.Generator | None = None
        # training's neighbor draws, for a backbone whose strategy is
        # stochastic (None otherwise: recent sampling draws nothing)
        self.sample_gen: torch.Generator | None = None
        self._stochastic = getattr(backbone, "sample_strategy", "recent") != "recent"
        # each evaluate's neighbor draws: one generator, re-seeded a sweep
        # (a captured eval graph keeps drawing from the generator it registered)
        self._eval_gen: torch.Generator | None = None
        self._early: EarlyStopping | None = None  # fit's, for resume checkpoints
        self.graphs = StepGraphs(self.device)

    # ----------------------------------------------------------- parameters
    def init_params(self, seed: int) -> None:
        """Build the backbone and head with parameters drawn from ``seed``,
        a fresh optimizer over them, and the dropout generator (and, for a
        stochastic sample strategy, the sampling generator) seeded from
        ``seed`` on the trainer's device."""
        gen = generator(seed)
        nd = self.tables.node_dim
        model = self.backbone.build(nd, self.tables.edge_dim, gen)
        head = MergeLayer(2 * nd, nd, 1, gen)
        self.model = model.to(self.device).eval()
        self.head = head.to(self.device).eval()
        self.optimizer = make_optimizer(
            self.cfg, list(self.model.parameters()) + list(self.head.parameters())
        )
        self.dropout_gen = generator(seed, self.device)
        if self._stochastic:
            self.sample_gen = generator(seed, self.device)
        self.graphs = StepGraphs(self.device)  # captured against the old modules
        if self.mesh is not None:
            if hasattr(self.model, "mesh"):  # node-sharded memory, Ulysses
                self.model.mesh = self.mesh
            # every rank starts from rank 0's parameters
            tensors = self._float_tensors()
            flat = replicated(torch.cat([t.reshape(-1) for t in tensors]), self.mesh,
                              "init/params")
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))

    def _float_tensors(self) -> list[torch.Tensor]:
        return [t for m in (self.model, self.head) for t in m.state_dict().values()
                if t.is_floating_point()]

    def load_params(self, params: dict) -> None:
        """Load ``{"backbone": state_dict, "head": state_dict}`` (see
        ``transfer.from_jax_params``; numpy arrays are accepted too)."""
        if self.model is None:
            self.init_params(0)
        as_t = lambda sd: {k: torch.as_tensor(v) for k, v in sd.items()}
        self.model.load_state_dict(as_t(params["backbone"]))
        self.head.load_state_dict(as_t(params["head"]))

    def state_dicts(self) -> dict:
        """``{"backbone": ..., "head": ...}`` state dicts of the current
        parameters (the form ``load_params`` and the checkpoints take)."""
        return {"backbone": self.model.state_dict(), "head": self.head.state_dict()}

    def init_state(self):
        """An empty memory on the trainer's device for a backbone with state
        (under a mesh, this rank's shard), else None."""
        return self.backbone.init_state(self.tables, self.mesh) if self.has_state else None

    def load_state(self, state):
        """A whole memory state (a checkpoint's, numpy or tensors) on the
        trainer's device; under a mesh, this rank's shard of it."""
        state = to_device(state, self.device)
        if state is None or self.mesh is None:
            return state
        return shard_state(state, self.mesh)

    def host_state(self, state):
        """The whole memory state of ``state`` (under a mesh, the shards
        gathered over the data axis: every rank takes part)."""
        if state is None or self.mesh is None:
            return state
        return gather_state(state, self.mesh, state_rows(self.tables.node.shape[0]))

    def _require_state(self, state) -> None:
        if self.has_state and state is None:
            raise ValueError(
                f"{type(self.backbone).__name__} carries a memory: pass state= "
                "(init_state() gives an empty one)")

    # -------------------------------------------------------------- forward
    def _layout(self, neg_src_is_src: bool = True) -> str:
        """The rows a batch embeds (the JAX trainer's ``_forward``):
        "dedup" (the triple, src's rows reused for neg_src), "triple" (a
        pair-aware net pairs the triple itself) or "quad". Training always
        has neg_src = src; evaluation only under random negatives."""
        if neg_src_is_src:
            if getattr(self.backbone, "pair_independent", False):
                return "dedup"
            if (not self.has_state and getattr(self.backbone, "triple_expand", False)
                    and not self._stochastic):
                return "triple"
        return "quad"

    def _sample(self, csr: TemporalCSR, arrays, layout: str, bucket=None, gen=None):
        """The inputs of the rows ``layout`` embeds: [src || dst || neg_dst]
        or [src || dst || neg_src || neg_dst]; ``gen`` draws the neighbors
        of a stochastic sample strategy."""
        src, dst, neg_src, neg_dst, ts = arrays[:5]
        if layout == "quad":
            ids, roles = torch.cat([src, dst, neg_src, neg_dst]), ("src", "dst", "src", "dst")
        else:
            ids, roles = torch.cat([src, dst, neg_dst]), ("src", "dst", "dst")
        tsx = ts.repeat(len(roles))
        if self._stochastic:
            inputs = self.backbone.sample(csr, ids, tsx, gen=gen)
        elif bucket is None:
            inputs = self.backbone.sample(csr, ids, tsx)
        else:
            inputs = self.backbone.sample(csr, ids, tsx, seq_len=bucket)
        if self.has_state:  # the layout's roles, explicit
            inputs = inputs._replace(roles=segment_roles(src.shape[0], roles, src.device))
        return inputs

    @staticmethod
    def _expand(embs: torch.Tensor, layout: str) -> torch.Tensor:
        """A "dedup" triple's rows [src, dst, neg_dst] -> quad order [src,
        dst, src, neg_dst]; the other layouts' rows are in quad order."""
        if layout != "dedup":
            return embs
        b = embs.shape[0] // 3
        return torch.cat([embs[: 2 * b], embs[:b], embs[2 * b :]])

    def _embed(self, inputs, layout: str, dropout_gen=None) -> torch.Tensor:
        """Quad-order embeddings [src, dst, neg_src, neg_dst] of a stateless
        backbone's inputs in ``layout``."""
        kw = {"triple": True} if layout == "triple" else {}
        return self._expand(self.model(self.tables, inputs, dropout_gen=dropout_gen, **kw),
                            layout)

    def _embed_memory(self, inputs, state, layout: str, dropout_gen=None):
        """A memory model's quad-order embeddings against ``state``'s view,
        and its raw embeddings in ``layout`` (whose first 2B rows, src and
        dst, are what ``commit`` takes)."""
        embs, raw = self.backbone.embed_quad(self.model, self.tables, state, inputs, dropout_gen)
        return self._expand(embs, layout), raw

    def _commit(self, state, arrays, raw, b: int | None = None):
        """The state after the batch's positive edges (``backbone.commit``);
        ``b``: the rows of each segment of ``raw`` (default: the batch's;
        this rank's under a mesh, where ``arrays`` are the global batch's)."""
        src, dst, _, _, ts, eid, valid = arrays
        b = src.shape[0] if b is None else b
        return self.backbone.commit(self.model, self.tables, state, src, dst, ts, eid, valid,
                                    raw[:b], raw[b : 2 * b])

    def _head_loss(self, embs, valid, denom=None):
        """Quad-order embeddings -> (masked mean BCE, (pos_logit, neg_logit));
        ``denom``: the mean's divisor (default 2 x the valid rows; a mesh
        passes the global batch's)."""
        s_e, d_e, ns_e, nd_e = embs.split(valid.shape[0])
        pos_logit = self.head(s_e, d_e)[..., 0]
        neg_logit = self.head(ns_e, nd_e)[..., 0]
        bce = F.binary_cross_entropy_with_logits
        bce_pos = bce(pos_logit, torch.ones_like(pos_logit), reduction="none")
        bce_neg = bce(neg_logit, torch.zeros_like(neg_logit), reduction="none")
        if denom is None:
            denom = torch.clamp(2.0 * valid.sum(), min=1.0)
        loss = ((bce_pos + bce_neg) * valid).sum() / denom
        return loss, (pos_logit, neg_logit)

    # ------------------------------------------------------------- the mesh
    def _shard(self, arrays):
        """(this rank's rows of the global batch arrays, the loss's global
        divisor); the batch itself and None without a mesh. Padded rows
        repeat the last real one and are not valid."""
        if self.mesh is None:
            return arrays, None
        local = tuple(batch_sharded(a, self.mesh) for a in arrays)
        real = row_slice(arrays[0].shape[0], self.mesh, arrays[0].device).real
        denom = torch.clamp(2.0 * arrays[6].sum(), min=1.0)
        return local[:6] + (local[6] * real,), denom

    def _sample_rows(self, csr, garrays, arrays, layout, bucket, gen):
        """``_sample`` of this rank's rows. A stochastic strategy under a
        mesh draws for the global batch, as one process would, and keeps
        this rank's rows of every segment."""
        if self.mesh is None or not self._stochastic:
            return self._sample(csr, arrays, layout, bucket, gen)
        inputs = self._sample(csr, garrays, layout, bucket, gen)
        nseg, b = (4 if layout == "quad" else 3), garrays[0].shape[0]
        rows = row_slice(b, self.mesh, garrays[0].device).rows

        def keep(x):
            if isinstance(x, tuple):
                items = [keep(v) for v in x]
                return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
            if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == nseg * b:
                return x.reshape(nseg, b, *x.shape[1:]).index_select(1, rows).reshape(
                    -1, *x.shape[1:])
            return x

        return keep(inputs)

    def _global(self, loss, pos, neg, b: int):
        """A step's loss and probabilities over the global batch: the loss
        summed over the data axis, the probabilities gathered into the
        global row order."""
        if self.mesh is None:
            return loss, (pos, neg)
        loss = all_reduce(loss.detach().clone(), self.mesh, DATA_AXIS, "step/loss")
        probs = gather_rows(torch.stack([pos, neg], dim=1), b, self.mesh, "step/probs")
        return loss, (probs[:, 0], probs[:, 1])

    def _reduce_grads(self) -> None:
        """Sum the gradients over every rank, in one flat buffer."""
        grads = [p.grad for m in (self.model, self.head) for p in m.parameters()
                 if p.grad is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh, None,
                          "train/grads")
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def train_step(self, arrays, bucket: int | None = None, state=None):
        """One optimizer step on a batch (train mode, dropout from the
        trainer's generator) -> (loss, (pos_probs, neg_probs)), detached.
        The parameters' ``.grad`` hold this step's gradients afterwards
        (None for those the loss does not reach). A memory model takes its
        memory as ``state`` and gets the committed state as a third element."""
        self._require_state(state)
        layout = self._layout()
        self.model.train()
        self.head.train()
        with record_function("train/sample"):
            garrays, (arrays, denom) = arrays, self._shard(arrays)
            valid = arrays[6]
            inputs = self._sample_rows(self.train_csr, garrays, arrays, layout, bucket,
                                       self.sample_gen)
        with record_function("train/forward"):
            if self.has_state:
                embs, raw = self._embed_memory(inputs, state, layout, self.dropout_gen)
            else:
                embs = self._embed(inputs, layout, self.dropout_gen)
            loss, (pos_logit, neg_logit) = self._head_loss(embs, valid, denom)
        with record_function("train/backward"):
            self.optimizer.zero_grad(set_to_none=True)
            if self.mesh is not None and self.mesh.model_size > 1:
                # the model axis's ranks each compute the whole loss: a
                # 1/mp share each makes the summed gradients the loss's
                (loss / self.mesh.model_size).backward()
            else:
                loss.backward()
            if self.mesh is not None:
                self._reduce_grads()
        if self.has_state:
            with record_function("train/commit"):  # the parameters before the step
                state = self._commit(state, garrays, raw.detach(), valid.shape[0])
        with record_function("train/optimizer"):
            self.optimizer.step()
        loss, probs = self._global(loss.detach(), torch.sigmoid(pos_logit).detach(),
                                   torch.sigmoid(neg_logit).detach(), garrays[0].shape[0])
        if self.has_state:
            return loss, probs, state
        return loss, probs

    @torch.inference_mode()
    def eval_step(self, csr: TemporalCSR, arrays, bucket: int | None = None, gen=None,
                  state=None, neg_src_is_src: bool = True):
        """One batch -> (masked mean BCE loss, (pos_probs, neg_probs)); ``gen``
        draws a stochastic strategy's neighbors. ``neg_src_is_src``: the
        batch's neg_src column is its src column (random negatives), so the
        triple may stand in for the quad (``_layout``); pass False for
        historical or inductive negatives. A memory model takes its memory
        as ``state`` and gets the state after the batch's positive edges as
        a third element."""
        self._require_state(state)
        layout = self._layout(neg_src_is_src)
        self.model.eval()
        self.head.eval()
        with record_function("eval/sample"):
            garrays, (arrays, denom) = arrays, self._shard(arrays)
            valid = arrays[6]
            inputs = self._sample_rows(csr, garrays, arrays, layout, bucket, gen)
        with record_function("eval/forward"):
            if self.has_state:
                embs, raw = self._embed_memory(inputs, state, layout)
            else:
                embs = self._embed(inputs, layout)
        with record_function("eval/head"):
            loss, (pos_logit, neg_logit) = self._head_loss(embs, valid, denom)
            loss, probs = self._global(loss, torch.sigmoid(pos_logit), torch.sigmoid(neg_logit),
                                       garrays[0].shape[0])
        if not self.has_state:
            return loss, probs
        with record_function("eval/commit"):
            return loss, probs, self._commit(state, garrays, raw, valid.shape[0])

    # ---------------------------------------------------------------- loops
    @staticmethod
    def _host_arrays(b: Batch, neg_src, neg_dst) -> tuple[np.ndarray, ...]:
        """(src, dst, neg_src, neg_dst, time keys, eid) int32 and valid float32."""
        i32 = lambda a: np.asarray(a, dtype=np.int32)
        return (i32(b.src), i32(b.dst), i32(neg_src), i32(neg_dst), i32(time_keys(b.ts)),
                i32(b.eid), np.asarray(b.valid, dtype=np.float32))

    def _batch_arrays(self, b: Batch, neg_src, neg_dst):
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in self._host_arrays(b, neg_src, neg_dst))

    def _stack(self, staged) -> tuple[torch.Tensor, ...]:
        """(batch, neg_src, neg_dst) triples -> their seven arrays as (T, B)
        device tensors (a scanned sweep's staging)."""
        return stack_columns((self._host_arrays(*row) for row in staged), self.device)

    def _pad_negs(self, neg: np.ndarray, b: Batch) -> np.ndarray:
        out = np.zeros(len(b.src), dtype=np.int64)
        out[: len(neg)] = neg
        if len(neg) < len(out):
            out[len(neg):] = neg[-1] if len(neg) else 0
        return out

    def _pick_bucket(self, csr: TemporalCSR, b: Batch, neg_src, neg_dst) -> int | None:
        """Smallest static sequence bucket covering this batch's histories
        (the longest strictly-before history over all 4B query nodes, +1
        for the target), or None for the full length."""
        if not self._buckets:
            return None
        key = id(csr)
        if key not in self._host_hist:
            # composite (node, time) keys are globally sorted, so one
            # searchsorted answers all strictly-before counts at once
            offsets = csr.offsets.cpu().numpy().astype(np.int64)
            tsarr = csr.ts.cpu().numpy().astype(np.int64)
            base = int(tsarr.max()) + 2 if tsarr.size else 2
            node_of = np.repeat(np.arange(len(offsets) - 1, dtype=np.int64), np.diff(offsets))
            self._host_hist[key] = (offsets, node_of * base + tsarr, base)
        offsets, comp, base = self._host_hist[key]
        tk = time_keys(b.ts)
        ids = np.concatenate(
            [np.asarray(x, dtype=np.int64) for x in (b.src, b.dst, neg_src, neg_dst)]
        )
        qt = np.minimum(np.tile(tk, 4), base - 1)
        counts = np.searchsorted(comp, ids * base + qt, side="left") - offsets[ids]
        mx = int(counts.max()) if counts.size else 0
        if mx >= self._buckets[-1] - 1:  # counts beyond maxlen-1 are truncated
            return None
        bucket = next(c for c in self._buckets if c >= 1 + mx)
        return None if bucket == self._buckets[-1] else bucket

    def _batch_metrics(self, probs, batch: Batch) -> dict[str, float]:
        n = batch.num_valid
        pos, neg = probs[0][:n], probs[1][:n]
        predicts = np.concatenate([pos, neg])
        labels = np.concatenate([np.ones(n), np.zeros(n)])
        return link_prediction_metrics(predicts, labels)

    def _train_negatives(self, stream: EdgeStream | None = None):
        """(batch, padded neg_dst) for each train batch of ``stream``
        (default: the train split), each batch's destinations drawn from the
        train sampler as the batch is reached."""
        stream = self.data.train if stream is None else stream
        for b in chronological_batches(stream, self.cfg.batch_size):
            _, neg_dst = self.train_neg.sample(b.num_valid)
            yield b, self._pad_negs(neg_dst, b)

    def train_batches(self, stream: EdgeStream | None = None):
        """(batch, arrays, bucket) for each train batch of ``stream``
        (default: the train split), drawing each batch's negatives from the
        train sampler as the batch is reached."""
        for b, neg_dst in self._train_negatives(stream):
            bucket = self._pick_bucket(self.train_csr, b, b.src, neg_dst)
            yield b, self._batch_arrays(b, b.src, neg_dst), bucket

    def train_epoch(self, stream: EdgeStream | None = None, state=None, epoch: int = 0,
                    start_batch: int = 0):
        """One pass over the train split (or ``stream``) -> (per-batch
        losses, per-batch AP/AUC dicts); a memory model's sweep starts from
        ``state`` (default: an empty memory) and its final state is a third
        element. With ``cfg.check_memory_order`` each step is checked for
        node clocks that move backwards; with ``cfg.show_progress`` each
        step's loss is shown on stderr (``epoch`` numbers the line).
        ``start_batch``: resume mid-epoch there (the batches before it still
        draw their negatives, so the sampler's stream stays aligned); with
        ``cfg.resume_every_batches`` a resume checkpoint is written every
        that many batches."""
        self._require_params()
        if self.has_state and state is None:
            state = self.init_state()
        losses, metrics = [], []
        for i, (b, neg_dst) in enumerate(self._train_negatives(stream)):
            if i < start_batch:
                continue
            bucket = self._pick_bucket(self.train_csr, b, b.src, neg_dst)
            arrays = self._batch_arrays(b, b.src, neg_dst)
            if not self.has_state:
                loss, (pos, neg) = self.train_step(arrays, bucket)
            else:
                clocks = self._clocks(state)
                loss, (pos, neg), state = self.train_step(arrays, bucket, state)
                self._check_order(clocks, state, f"train batch {i}")
            host = (pos.cpu().numpy(), neg.cpu().numpy())
            losses.append(float(loss))
            metrics.append(self._batch_metrics(host, b))
            if self.cfg.show_progress:
                print(f"\rEpoch: {epoch + 1}, train for the {i + 1}-th batch, "
                      f"train loss: {losses[-1]:.4f}", end="", file=sys.stderr, flush=True)
            every = self.cfg.resume_every_batches
            if every and (i + 1) % every == 0:
                self._write_resume(epoch, i + 1, state)
        if self.cfg.show_progress and losses:
            print(file=sys.stderr)  # ends the progress line
        return (losses, metrics, state) if self.has_state else (losses, metrics)

    def _require_params(self) -> None:
        if self.model is None:
            raise RuntimeError("call init_params or load_params first")

    def _packed(self, out):
        """A step's outputs as ((loss, pos, neg), state or None)."""
        return (out[0], *out[1]), (out[2] if self.has_state else None)

    def train_epoch_scanned(self, stream: EdgeStream | None = None, state=None,
                            epoch: int = 0):
        """``train_epoch`` as the JAX ``train_epoch_scanned`` runs it: the
        epoch's negatives drawn first (the per-batch order, so the sampler's
        stream is the same), its batches staged on the device at once, every
        step at the full sequence length (no bucket) and replayed as a CUDA
        graph after the first (``StepGraphs``; eagerly off the card), the
        losses and probabilities read back once. Memory order is checked
        once for the epoch; no resume checkpoint is written. Same returns
        as ``train_epoch``."""
        self._require_params()
        if self.has_state and state is None:
            state = self.init_state()
        staged = [(b, b.src, neg_dst) for b, neg_dst in self._train_negatives(stream)]
        clocks = self._clocks(state)

        def step(arrays, st):
            return self._packed(self.train_step(arrays, None, st))

        gens = [g for g in (self.dropout_gen, self.sample_gen) if g is not None]
        (loss, pos, neg), state = self.graphs.scan(("train",), step, self._stack(staged), state,
                                                   gens)
        self._check_order(clocks, state, f"epoch {epoch} (scan)")
        losses, pos, neg = loss.tolist(), pos.cpu().numpy(), neg.cpu().numpy()
        metrics = [self._batch_metrics((pos[i], neg[i]), b) for i, (b, _, _) in enumerate(staged)]
        return (losses, metrics, state) if self.has_state else (losses, metrics)

    def _write_resume(self, epoch: int, next_batch: int, state) -> None:
        """``<save_path>.resume``: what ``fit(resume=True)`` restarts from."""
        if self.save_path is None:
            raise ValueError("resume_every_batches writes <save_path>.resume; pass save_path")
        gens = {"dropout_gen": self.dropout_gen, "sample_gen": self.sample_gen}
        state = self.host_state(state)  # every rank gathers; the lead writes
        if not self.is_lead:
            return
        save_checkpoint(self.save_path + ".resume", self.state_dicts(), state, extra={
            "epoch": epoch,
            "next_batch": next_batch,
            "opt_state": to_cpu(self.optimizer.state_dict()),
            "early_best": dict(self._early.best) if self._early else {},
            "early_counter": self._early.counter if self._early else 0,
            "generators": {k: g.get_state() for k, g in gens.items() if g is not None},
        })

    def _load_resume(self, ck: dict):
        """Parameters, optimizer state, generators and early stopping from a
        resume checkpoint -> (epoch, next batch, memory state or None)."""
        extra = ck["extra"]
        self.load_params(ck["params"])
        self.optimizer.load_state_dict(extra["opt_state"])
        self.graphs = StepGraphs(self.device)  # the optimizer's state tensors are new
        for name, st in extra["generators"].items():
            getattr(self, name).set_state(st)
        self._early.best = dict(extra["early_best"])
        self._early.counter = extra["early_counter"]
        return extra["epoch"], extra["next_batch"], self.load_state(ck["state"])

    def _clocks(self, state):
        """Host copies of the memory's clocks, under ``cfg.check_memory_order``."""
        if not self.cfg.check_memory_order:
            return None
        return state.last_update.cpu().numpy(), state.msg_time.cpu().numpy()

    @staticmethod
    def _check_order(clocks, new_state, where: str) -> None:
        if clocks is None:
            return
        n = memory_order_violations(*clocks, new_state)
        if n:
            raise RuntimeError(
                f"memory order violated at {where}: {n} node clock(s) moved backwards "
                "(batches applied out of chronological order, or a corrupted state)")

    def _eval_negatives(self, stream: EdgeStream, neg_sampler: NegativeEdgeSampler,
                        random_negs: bool):
        """(batch, padded neg_src, padded neg_dst) for each batch of a sweep,
        drawn as the batch is reached. Random negatives: the neg_src draw is
        made so the seeded stream stays aligned, then discarded (the negative
        edge is (src, neg_dst)); historical and inductive: the drawn pair."""
        for b in chronological_batches(stream, self.cfg.batch_size):
            n = b.num_valid
            if random_negs:
                _, neg_dst = neg_sampler.sample(n)
                neg_src = b.src[:n]
            else:
                neg_src, neg_dst = neg_sampler.sample(
                    n, batch_src_node_ids=b.src[:n], batch_dst_node_ids=b.dst[:n],
                    current_batch_start_time=b.batch_start_time,
                    current_batch_end_time=b.batch_end_time)
            yield b, self._pad_negs(neg_src, b), self._pad_negs(neg_dst, b)

    def evaluate(self, stream: EdgeStream, neg_sampler: NegativeEdgeSampler,
                 eval_key_salt: int = 0, state=None, scanned: bool | None = None):
        """One sweep over a split, with negatives from ``neg_sampler`` under
        its strategy (random: neg_src discarded for src; historical and
        inductive: the drawn pairs, embedded as the quad); a stochastic
        sample strategy draws from a generator seeded from 12345 +
        ``eval_key_salt``.

        Returns (losses, metrics, probs): per batch, the loss, the AP/AUC
        dict and the host (pos_probs, neg_probs) arrays (padded rows
        included). A memory model's sweep starts from ``state`` (default:
        an empty memory), commits each batch's positive edges and returns
        the final state as a fourth element; ``state`` itself is not
        modified.

        ``scanned`` stages the whole sweep first and replays its steps as
        CUDA graphs (``train_epoch_scanned``'s way; the full sequence
        length); None: ``cfg.scan_epochs`` unless the backbone has sequence
        buckets, as the JAX package decides. Both give the same draws.
        """
        self._require_params()
        if self.has_state and state is None:
            state = self.init_state()
        if stream.num_interactions == 0:
            return ([], [], [], state) if self.has_state else ([], [], [])
        if scanned is None:
            scanned = self.cfg.scan_epochs and not self._buckets
        neg_sampler.reset_random_state()
        random_negs = neg_sampler.negative_sample_strategy == "random"
        gen = self._eval_gen = (eval_generator(self._eval_gen, self.device, eval_key_salt)
                                if self._stochastic else None)
        batches = self._eval_negatives(stream, neg_sampler, random_negs)
        if scanned:
            staged = list(batches)

            def step(arrays, st):
                return self._packed(self.eval_step(self.full_csr, arrays, None, gen, st,
                                                   neg_src_is_src=random_negs))

            key = ("eval", self._layout(random_negs), id(self.full_csr))
            (loss, pos, neg), state = self.graphs.scan(
                key, step, self._stack(staged), state, [gen] if gen is not None else [])
            losses, pos, neg = loss.tolist(), pos.cpu().numpy(), neg.cpu().numpy()
            probs = [(pos[i], neg[i]) for i in range(len(staged))]
            metrics = [self._batch_metrics(p, b) for p, (b, _, _) in zip(probs, staged)]
            return (losses, metrics, probs, state) if self.has_state else (losses, metrics, probs)
        losses, metrics, probs = [], [], []
        for _ in range(-(-stream.num_interactions // self.cfg.batch_size)):
            with record_function("eval/staging"):
                b, ns, nd = next(batches)
                bucket = self._pick_bucket(self.full_csr, b, ns, nd)
                arrays = self._batch_arrays(b, ns, nd)
            out = self.eval_step(self.full_csr, arrays, bucket, gen, state,
                                 neg_src_is_src=random_negs)
            if self.has_state:
                loss, (pos, neg), state = out
            else:
                loss, (pos, neg) = out
            with record_function("eval/metrics"):  # the copy-back waits for the device
                host = (pos.cpu().numpy(), neg.cpu().numpy())
                losses.append(float(loss))
                metrics.append(self._batch_metrics(host, b))
                probs.append(host)
        return (losses, metrics, probs, state) if self.has_state else (losses, metrics, probs)

    def _sweep(self, stream, sampler, salt, state=None):
        """(mean metrics, final state or None) of one ``evaluate``."""
        out = self.evaluate(stream, sampler, salt, state=state)
        return self.mean_metrics(out[1]), (out[3] if self.has_state else None)

    @staticmethod
    def mean_metrics(metrics: list[dict]) -> dict[str, float]:
        if not metrics:
            return {}
        return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}

    def fit(self, seed: int = 0, log=print, resume: bool = False) -> dict:
        """The reference's choreography for one run; returns the results
        dict with the JAX package's keys ("train losses", "validate
        metrics", "new node validate metrics", "test metrics", "new node
        test metrics", "params", "state").

        ``resume``: restart from ``<save_path>.resume`` where one exists
        (written every ``cfg.resume_every_batches`` train batches; under a
        mesh by the lead rank, and read by every rank: they must share
        the path). An epoch
        scans (``train_epoch_scanned``) under ``cfg.scan_epochs`` unless it
        resumes mid-epoch or resume checkpoints are written, as in the JAX
        ``fit``. ``cfg.profile_dir``: the second epoch (train and both val
        sweeps) runs under ``torch.profiler`` and its trace is written
        there; ``cfg.tensorboard_dir``: one scalar record per epoch."""
        if self.save_path is None:
            raise ValueError("fit writes its best checkpoint to save_path; pass one")
        self.init_params(seed)
        n_params = sum(p.numel() for m in (self.model, self.head) for p in m.parameters())
        log(
            f"model name: {type(self.backbone).__name__}, "
            f"#parameters: {n_params * 4} B, {n_params * 4 / 1024:.4f} KB, "
            f"{n_params * 4 / 1024 / 1024:.4f} MB."
        )
        # under a mesh every rank decides from the same metrics; the lead
        # writes the checkpoint, the others keep theirs in memory
        early = self._early = EarlyStopping(self.cfg.patience, self.save_path,
                                            write=self.is_lead)
        start_epoch, start_batch, resume_state = 0, 0, None
        if resume and os.path.exists(self.save_path + ".resume"):
            start_epoch, start_batch, resume_state = self._load_resume(
                load_checkpoint(self.save_path + ".resume"))
            log(f"resuming from epoch {start_epoch + 1}, batch {start_batch}")
        tb_dir = self.cfg.tensorboard_dir if self.is_lead else ""
        with SummaryWriter(tb_dir) if tb_dir else contextlib.nullcontext() as tb:
            epoch_mean_losses, mv, nn_mv = self._fit_epochs(
                early, start_epoch, start_batch, resume_state, tb, log)

        best = early.load_best()
        self.load_params(best["params"])
        state = self.load_state(best["state"])
        d = self.data
        results: dict = {"train losses": epoch_mean_losses}
        if self.has_state:
            # the checkpoint's memory has seen val: the last epoch's val
            # metrics stand, as the JAX package reports them
            results["validate metrics"], results["new node validate metrics"] = mv, nn_mv
        else:
            results["validate metrics"] = self._sweep(d.val, self.val_neg, 0)[0]
            results["new node validate metrics"] = self._sweep(
                d.new_node_val, self.nn_val_neg, 1)[0]
        results["test metrics"] = self._sweep(d.test, self.test_neg, 2, state)[0]
        results["new node test metrics"] = self._sweep(
            d.new_node_test, self.nn_test_neg, 3, state)[0]
        results["params"] = self.state_dicts()
        results["state"] = state
        return results

    def _fit_epochs(self, early, start_epoch, start_batch, resume_state, tb, log):
        """``fit``'s epochs -> (each epoch's mean train loss, the last val
        and new-node val metrics)."""
        epoch_mean_losses: list[float] = []
        mv, nn_mv = {}, {}
        d = self.data
        for epoch in range(start_epoch, self.cfg.num_epochs):
            t0 = time.time()
            profiler = None
            if self.cfg.profile_dir and epoch == start_epoch + 1:
                profiler = self._profiler()
                profiler.start()
            # a memory model's epoch starts from an empty memory (or the
            # resumed one)
            state = resume_state if epoch == start_epoch else None
            sb = start_batch if epoch == start_epoch else 0
            if self.cfg.scan_epochs and sb == 0 and not self.cfg.resume_every_batches:
                out = self.train_epoch_scanned(state=state, epoch=epoch)
            else:
                out = self.train_epoch(state=state, epoch=epoch, start_batch=sb)
            tr_losses, tr_metrics = out[:2]
            train_state = out[2] if self.has_state else None
            mv, val_state = self._sweep(d.val, self.val_neg, 0, train_state)
            nn_mv, _ = self._sweep(d.new_node_val, self.nn_val_neg, 1, train_state)
            if profiler is not None:
                profiler.stop()
                log(f"profiler trace written to {self.cfg.profile_dir}")
            epoch_mean_losses.append(float(np.mean(tr_losses)))
            dt = time.time() - t0
            n_train = len(tr_losses) * self.cfg.batch_size
            train_ap = self.mean_metrics(tr_metrics).get("average_precision", 0.0)
            log(
                f"epoch {epoch + 1}: train loss {np.mean(tr_losses):.4f} ap {train_ap:.4f}"
                f" | val {mv} | nn-val ap {nn_mv.get('average_precision', 0):.4f} "
                f"({dt:.1f}s, ~{n_train / max(dt, 1e-9):.0f} edges/s incl. eval)"
            )
            if tb is not None:
                tb.add_scalars({
                    "train/loss": float(np.mean(tr_losses)),
                    "train/average_precision": train_ap,
                    **{f"val/{k}": v for k, v in mv.items()},
                    "new_node_val/average_precision": nn_mv.get("average_precision", 0.0),
                    "perf/epoch_seconds": dt,
                    "perf/edges_per_second": n_train / max(dt, 1e-9),
                }, step=epoch + 1)
            if (epoch + 1) % self.cfg.test_interval_epochs == 0:
                log(f"  test {self._sweep(d.test, self.test_neg, 2, val_state)[0]}")
            if early.step(mv, self.state_dicts(), self.host_state(val_state)):
                log(f"early stop at epoch {epoch + 1}")
                break
        return epoch_mean_losses, mv, nn_mv

    def _profiler(self) -> torch.profiler.profile:
        """A profiler of the host (and of the card on ``cuda``) whose trace
        goes into ``cfg.profile_dir`` when it stops."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(self.cfg.profile_dir))
