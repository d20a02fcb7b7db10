"""Dynamic node classification: a frozen backbone and an MLPClassifier head.

Counterpart of ``dyglib_tpu/train/node_classification.py``. Protocol (the
JAX package's):
  * the backbone's parameters come from a link-prediction checkpoint and
    stay frozen: the net runs in eval mode (no dropout) under
    ``torch.no_grad``, its parameters take no gradient, and the optimizer
    holds only the head's;
  * the head is trained with BCE on the SOURCE node's embedding against
    the edge's label, masked over the padded last batch; its dropout draws
    from the trainer's ``dropout_gen``;
  * the metric is ROC-AUC over the whole split (each batch's valid rows);
  * the rows a batch embeds (``layout``): src alone for a stateless
    pair-independent backbone (TGAT, GraphMixer), [src || dst] for a
    memory model (its commit needs both), the triple [src || dst || dst]
    that a ``triple_expand`` net pairs itself (DyGFormer, TCL), else the
    quad [src || dst || src || dst] (CAWN); a memory model's roles follow
    the rows built, and its rows commit through ``embed_quad`` + ``commit``
    (every edge is positive); DyGFormer samples at its full length;
  * the memory is re-initialized every epoch, val continues from the train
    sweep's state, the best checkpoint holds the head's state dict and that
    post-val state, and test runs from it;
  * training and evaluation both sample from the full stream's CSR; a
    stochastic strategy draws from ``sample_gen`` in training and, in each
    ``evaluate``, from a generator seeded afresh from 12345 + ``salt``;
  * scan epochs (``cfg.scan_epochs``): a head epoch and an eval sweep are
    staged on the device at once (every batch full, as the JAX
    ``_stacked_batches`` requires) and their steps replayed as CUDA graphs
    after the first (``step_graph.StepGraphs``; eagerly off the card).

Each step's phases are ``torch.profiler`` ranges: ``nodecls/sample``,
``nodecls/forward``, ``nodecls/commit`` (memory models), ``nodecls/head``,
and in training ``nodecls/backward`` and ``nodecls/optimizer``
(``scripts/profile_torch_eval.py --task node_classification``).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..data.batching import Batch, chronological_batches
from ..data.containers import EdgeStream
from ..data.datasets import NodeClassificationData
from ..device import resolve_device
from ..graph.csr import build_temporal_csr, time_keys
from ..models.base import FeatureTables
from ..models.memory_model import segment_roles
from ..nn.modules import MLPClassifier
from ..utils.rng import generator
from .checkpoints import to_device
from .early_stopping import EarlyStopping
from .link_prediction import ENTRY_TABLE_BUDGET, TrainConfig, make_optimizer
from .metrics import node_classification_metrics
from .step_graph import StepGraphs, eval_generator, stack_columns


class NodeClassificationTrainer:
    """Owns the feature tables, the full stream's CSR, the frozen backbone
    net (built by ``backbone.build`` and loaded from ``backbone_params``,
    a state dict), the head, its optimizer and the dropout and sampling
    generators for one dataset on one device."""

    def __init__(
        self,
        backbone,
        data: NodeClassificationData,
        cfg: TrainConfig,
        save_path: str | None,
        backbone_params: dict,
        device: str | torch.device | None = None,
    ):
        self.backbone = backbone
        self.data = data
        self.cfg = cfg
        self.save_path = save_path
        self.has_state = getattr(backbone, "has_state", False)
        self.device = dev = resolve_device(device)
        self.tables = FeatureTables(
            node=torch.from_numpy(data.node_raw_features).to(dev),
            edge=torch.from_numpy(data.edge_raw_features).to(dev),
        )
        strategy = getattr(backbone, "sample_strategy", "recent")
        csr_kw = {}
        prefix_bytes = 2 * data.full.num_interactions * data.node_raw_features.shape[1] * 4
        if getattr(backbone, "wants_feat_prefix", False) and prefix_bytes <= ENTRY_TABLE_BUDGET:
            csr_kw["feat_prefix_of"] = data.node_raw_features
        if strategy == "time_interval_aware":
            csr_kw.update(with_tia=True, time_scaling_factor=cfg.time_scaling_factor)
        self.full_csr = build_temporal_csr(data.full, num_nodes=data.num_nodes, device=dev,
                                           **csr_kw)
        model = backbone.build(self.tables.node_dim, self.tables.edge_dim,
                               generator(0))
        model.load_state_dict({k: torch.as_tensor(v) for k, v in backbone_params.items()})
        self.model = model.to(dev).eval().requires_grad_(False)
        # the rows a batch embeds, as the JAX trainer's _src_embeddings picks them
        if getattr(backbone, "pair_independent", False):
            self.layout = ("src", "dst") if self.has_state else ("src",)
        elif getattr(backbone, "triple_expand", False):
            self.layout = ("src", "dst", "dst")
        else:
            self.layout = ("src", "dst", "src", "dst")
        self._stochastic = strategy != "recent"
        self.head: MLPClassifier | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.dropout_gen: torch.Generator | None = None
        self.sample_gen: torch.Generator | None = None
        self._eval_gen: torch.Generator | None = None  # re-seeded a sweep
        self.graphs = StepGraphs(dev)

    # ----------------------------------------------------------- parameters
    def init_params(self, seed: int) -> None:
        """A head drawn from ``seed``, a fresh optimizer over its parameters
        only, and the dropout (and, for a stochastic strategy, sampling)
        generators seeded from ``seed`` on the trainer's device."""
        gen = generator(seed)
        self.head = MLPClassifier(self.tables.node_dim, gen, self.cfg.head_dropout).to(self.device)
        self.optimizer = make_optimizer(self.cfg, list(self.head.parameters()))
        self.dropout_gen = generator(seed, self.device)
        if self._stochastic:
            self.sample_gen = generator(seed, self.device)
        self.graphs = StepGraphs(self.device)  # captured against the old head

    def load_head(self, params: dict) -> None:
        """Load the head's state dict (numpy arrays are accepted too)."""
        if self.head is None:
            self.init_params(0)
        self.head.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})

    def init_state(self):
        """An empty memory on the trainer's device for a backbone with
        state, else None."""
        return self.backbone.init_state(self.tables) if self.has_state else None

    def _require_state(self, state) -> None:
        if self.has_state and state is None:
            raise ValueError(
                f"{type(self.backbone).__name__} carries a memory: pass state= "
                "(init_state() gives an empty one)")

    # -------------------------------------------------------------- forward
    @staticmethod
    def _host_arrays(b: Batch) -> tuple[np.ndarray, ...]:
        """(src, dst, time keys, eid) int32, valid float32 and label float32."""
        i32 = lambda a: np.asarray(a, dtype=np.int32)
        return (i32(b.src), i32(b.dst), i32(time_keys(b.ts)), i32(b.eid),
                np.asarray(b.valid, dtype=np.float32), np.asarray(b.label, dtype=np.float32))

    def _batch_arrays(self, b: Batch):
        """(src, dst, time keys, eid, valid) of a batch on the device."""
        return tuple(torch.from_numpy(a).to(self.device) for a in self._host_arrays(b)[:5])

    def _stacked_batches(self, stream: EdgeStream):
        """(batches, their (src, dst, time keys, eid, valid, label) as (T, B)
        device tensors, one copy each); every batch must be full (padded), as
        the JAX ``_stacked_batches`` requires of a scan."""
        batches = list(chronological_batches(stream, self.cfg.batch_size))
        if any(len(b.src) != self.cfg.batch_size for b in batches):
            raise ValueError("the scan path needs uniform (padded) batches; got a ragged batch")
        return batches, stack_columns((self._host_arrays(b) for b in batches), self.device)

    @torch.no_grad()
    def _src_embeddings(self, arrays, state=None, gen=None):
        """The frozen backbone's embeddings of the batch's source rows, and
        the state after committing the batch's edges (None for a stateless
        backbone); ``gen`` draws a stochastic strategy's neighbors."""
        src, dst, ts, eid, valid = arrays
        b = src.shape[0]
        with record_function("nodecls/sample"):
            rows = {"src": src, "dst": dst}
            ids = torch.cat([rows[r] for r in self.layout])
            kw = {"gen": gen} if self._stochastic else {}
            inputs = self.backbone.sample(self.full_csr, ids, ts.repeat(len(self.layout)), **kw)
            if self.has_state:
                inputs = inputs._replace(roles=segment_roles(b, self.layout, src.device))
        if not self.has_state:
            with record_function("nodecls/forward"):
                kw = {"triple": True} if len(self.layout) == 3 else {}
                return self.model(self.tables, inputs, **kw)[:b], state
        with record_function("nodecls/forward"):
            embs, raw = self.backbone.embed_quad(self.model, self.tables, state, inputs)
        with record_function("nodecls/commit"):
            state = self.backbone.commit(self.model, self.tables, state, src, dst, ts, eid,
                                         valid, raw[:b], raw[b : 2 * b])
        return embs[:b], state

    def head_loss(self, src_emb, labels, valid, dropout_gen=None):
        """(BCE of the head's logits against ``labels``, masked by ``valid``
        and averaged over the valid rows; the logits)."""
        logits = self.head(src_emb, dropout_gen)[..., 0]
        bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        return (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0), logits

    def train_step(self, arrays, labels: torch.Tensor, state=None):
        """One optimizer step of the head on a batch -> (loss, probabilities,
        state after the batch's commit), detached. The head's ``.grad`` hold
        this step's gradients afterwards; the backbone's stay None."""
        self._require_state(state)
        self.head.train()
        src_emb, state = self._src_embeddings(arrays, state, self.sample_gen)
        with record_function("nodecls/head"):
            loss, logits = self.head_loss(src_emb, labels, arrays[4], self.dropout_gen)
        with record_function("nodecls/backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("nodecls/optimizer"):
            self.optimizer.step()
        return loss.detach(), torch.sigmoid(logits).detach(), state

    @torch.inference_mode()
    def eval_step(self, arrays, state=None, gen=None):
        """One batch -> (probabilities, state after the batch's commit)."""
        self._require_state(state)
        self.head.eval()
        src_emb, state = self._src_embeddings(arrays, state, gen)
        with record_function("nodecls/head"):
            return torch.sigmoid(self.head(src_emb)[..., 0]), state

    # ---------------------------------------------------------------- loops
    def train_epoch(self, stream: EdgeStream | None = None, state=None):
        """One pass of head training over the train split (or ``stream``) ->
        (per-batch losses, final state); a memory model's sweep starts from
        ``state`` (default: an empty memory)."""
        if self.head is None:
            raise RuntimeError("call init_params or load_head first")
        stream = self.data.train if stream is None else stream
        if self.has_state and state is None:
            state = self.init_state()
        losses = []
        for b in chronological_batches(stream, self.cfg.batch_size):
            labels = torch.from_numpy(b.label.astype(np.float32)).to(self.device)
            loss, _, state = self.train_step(self._batch_arrays(b), labels, state)
            losses.append(float(loss))
        return losses, state

    def train_epoch_scanned(self, stream: EdgeStream | None = None, state=None):
        """``train_epoch`` as the JAX ``train_scan`` runs it: the batches
        staged on the device at once, every step after the first replayed as
        a CUDA graph (eagerly off the card), the losses read back once."""
        if self.head is None:
            raise RuntimeError("call init_params or load_head first")
        stream = self.data.train if stream is None else stream
        if self.has_state and state is None:
            state = self.init_state()
        _, stacked = self._stacked_batches(stream)

        def step(x, st):
            loss, _, st = self.train_step(x[:5], x[5], st)
            return (loss,), st

        gens = [g for g in (self.dropout_gen, self.sample_gen) if g is not None]
        (loss,), state = self.graphs.scan(("train",), step, stacked, state, gens)
        return loss.tolist(), state

    def evaluate(self, stream: EdgeStream, state=None, salt: int = 0,
                 scanned: bool | None = None):
        """One sweep over a split -> (global ROC-AUC dict, final state); a
        memory model's sweep starts from ``state`` (default: an empty
        memory) and commits every edge; ``state`` itself is not modified.
        ``scanned`` (default ``cfg.scan_epochs``): stage the sweep at once
        and replay its steps as CUDA graphs, as ``train_epoch_scanned``."""
        if self.head is None:
            raise RuntimeError("call init_params or load_head first")
        if self.has_state and state is None:
            state = self.init_state()
        gen = self._eval_gen = (eval_generator(self._eval_gen, self.device, salt)
                                if self._stochastic else None)
        if scanned is None:
            scanned = self.cfg.scan_epochs
        if scanned:
            batches, stacked = self._stacked_batches(stream)

            def step(x, st):
                p, st = self.eval_step(x[:5], st, gen)
                return (p,), st

            (p_all,), state = self.graphs.scan(("eval",), step, stacked, state,
                                               [gen] if gen is not None else [])
            p_all = p_all.cpu().numpy()
            probs = [p_all[i][: b.num_valid] for i, b in enumerate(batches)]
            labels = [b.label[: b.num_valid] for b in batches]
            return node_classification_metrics(np.concatenate(probs),
                                               np.concatenate(labels)), state
        probs, labels = [], []
        for b in chronological_batches(stream, self.cfg.batch_size):
            p, state = self.eval_step(self._batch_arrays(b), state, gen)
            n = b.num_valid
            probs.append(p.cpu().numpy()[:n])
            labels.append(b.label[:n])
        return node_classification_metrics(np.concatenate(probs), np.concatenate(labels)), state

    def fit(self, seed: int = 0, log=print) -> dict:
        """The reference's head-training choreography for one run; returns
        {"train losses" (each epoch's mean), "validate metrics" (the best
        epoch's), "test metrics" (from the best checkpoint), "head_params"}."""
        if self.save_path is None:
            raise ValueError("fit writes its best checkpoint to save_path; pass one")
        self.init_params(seed)
        n_params = sum(p.numel() for m in (self.model, self.head) for p in m.parameters())
        log(
            f"model name: {type(self.backbone).__name__}+MLPClassifier, "
            f"#parameters: {n_params * 4} B, {n_params * 4 / 1024:.4f} KB, "
            f"{n_params * 4 / 1024 / 1024:.4f} MB."
        )
        early = EarlyStopping(self.cfg.patience, self.save_path)
        epoch_mean_losses: list[float] = []
        for epoch in range(self.cfg.num_epochs):
            t0 = time.time()
            # a memory model's epoch starts from an empty memory
            losses, state = (self.train_epoch_scanned() if self.cfg.scan_epochs
                             else self.train_epoch())
            val_metrics, val_state = self.evaluate(self.data.val, state=state, salt=0)
            epoch_mean_losses.append(float(np.mean(losses)))
            log(
                f"epoch {epoch + 1}: train loss {np.mean(losses):.4f} "
                f"val auc {val_metrics['roc_auc']:.4f} ({time.time() - t0:.1f}s)"
            )
            if early.step(val_metrics, self.head.state_dict(), val_state):
                log(f"early stop at epoch {epoch + 1}")
                break
        best = early.load_best()
        self.load_head(best["params"])
        test_metrics, _ = self.evaluate(
            self.data.test, state=to_device(best["state"], self.device), salt=1)
        return {
            "train losses": epoch_mean_losses,
            "validate metrics": dict(early.best),
            "test metrics": test_metrics,
            "head_params": self.head.state_dict(),
        }
