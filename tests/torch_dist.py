"""Helpers for the port's multi-rank tests on the CPU (not a test module).

``run_ranks`` starts ``world`` processes (the ``spawn`` start method, so a
child imports only torch, the port and this module), joins them in one
gloo process group on a free local port, runs ``fn(rank, world, ...)``
on each and returns the ranks' results in rank order. A rank that raises
fails the call with its traceback; ranks that do not finish within
``timeout`` seconds are killed and the call fails. The workers below are
the checks the test files ask of the ranks; ``train_case`` runs the same
code in the test process (``mesh=None``) for the single-process side, on
one torch thread as the ranks run.
"""
from __future__ import annotations

import functools
import multiprocessing as mp
import queue
import time
import traceback

import numpy as np
import torch

FIXTURE = dict(num_src=120, num_dst=60, num_edges=2000, node_feat_scale=1.0, seed=7)


def _entry(fn, rank, world, port, args, q):
    torch.set_num_threads(1)
    try:
        from dyglib_tpu_torch.parallel import initialize_distributed, shutdown_distributed

        initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        try:
            q.put((rank, "ok", fn(rank, world, *args)))
        finally:
            shutdown_distributed()
    except Exception:  # the parent reports it
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 240.0) -> list:
    from dyglib_tpu_torch.parallel import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks did not finish "
                                   f"within {timeout} s")
            try:
                rank, status, value = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ------------------------------------------------------------ the checks
def one_thread(fn):
    """Run ``fn`` on one torch thread, as the ranks run: the test process
    shares the machine with the other test workers and the ranks."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(n)
    return run


def fixture_data():
    from dyglib_tpu_torch.data import synthetic_link_prediction_data

    return synthetic_link_prediction_data(**FIXTURE)


def backbone(name: str):
    """The tiny per-family configurations of the JAX mesh test, dropout 0."""
    from dyglib_tpu_torch.models import CAWN, TCL, TGAT, DyGFormer, GraphMixer, MemoryModel

    return {
        "TGAT": lambda: TGAT(num_neighbors=4, num_layers=2, dropout=0.0),
        "TGAT-uniform": lambda: TGAT(num_neighbors=4, num_layers=2, dropout=0.0,
                                     sample_strategy="uniform"),
        "TGAT-tia": lambda: TGAT(num_neighbors=4, num_layers=2, dropout=0.0,
                                 sample_strategy="time_interval_aware"),
        "TGN": lambda: MemoryModel("TGN", num_neighbors=4, num_layers=1, dropout=0.0),
        "DyRep": lambda: MemoryModel("DyRep", num_neighbors=4, num_layers=1, dropout=0.0),
        "JODIE": lambda: MemoryModel("JODIE", dropout=0.0),
        "CAWN": lambda: CAWN(num_neighbors=4, walk_length=1, num_walk_heads=2, dropout=0.0),
        "TCL": lambda: TCL(num_neighbors=4, num_layers=1, dropout=0.0),
        "GraphMixer": lambda: GraphMixer(num_neighbors=4, num_layers=1, time_gap=32,
                                         dropout=0.0),
        "DyGFormer": lambda: DyGFormer(max_input_sequence_length=16, patch_size=2,
                                       num_layers=1, dropout=0.0),
        "DyGFormer-ulysses": lambda: DyGFormer(max_input_sequence_length=16, patch_size=2,
                                               num_layers=1, dropout=0.0,
                                               sequence_axis="model"),
    }[name]()


def trainer(name: str, mesh=None, data=None, **cfg):
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = fixture_data() if data is None else data
    tr = LinkPredictionTrainer(backbone(name), data, TrainConfig(learning_rate=1e-3, **cfg),
                               device="cpu", mesh=mesh)
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=3)
    tr.init_params(0)
    return tr


@one_thread
def train_case(name: str, mesh=None, scanned: bool = False) -> dict:
    """The val probabilities of the seed-0 parameters, then one train epoch
    (seeded negatives) and the val sweep: the per-batch losses, the mean
    val AP and the val probabilities."""
    tr = trainer(name, mesh)
    init_probs = [np.concatenate(p) for p in tr.evaluate(tr.data.val, tr.val_neg, 0)[2]]
    epoch = tr.train_epoch_scanned if scanned else tr.train_epoch
    out = epoch()
    state = out[2] if tr.has_state else None
    ev = tr.evaluate(tr.data.val, tr.val_neg, 0, state=state, scanned=scanned)
    return {"losses": np.asarray(out[0]), "val_ap": tr.mean_metrics(ev[1])["average_precision"],
            "val_probs": [np.concatenate(p) for p in ev[2]], "init_val_probs": init_probs}


def mesh_cases(rank, world, cases) -> dict:
    """``train_case`` of each (name, data parallelism, model parallelism,
    scanned) on a mesh of the world's ranks, and each case's collective
    counts."""
    from dyglib_tpu_torch.parallel import collective_counts, make_mesh, reset_collective_counts

    out = {}
    for name, mp_, scanned in cases:
        mesh = make_mesh(world, model_parallelism=mp_)
        reset_collective_counts()
        res = train_case(name, mesh, scanned)
        res["collectives"] = collective_counts()
        out[(name, mp_, scanned)] = res
    return out


def seeded_batches(tr, n: int):
    """The global arrays of the first ``n`` train batches, negatives from
    the trainer's seeded sampler."""
    out = []
    for i, (b, neg_dst) in enumerate(tr._train_negatives()):
        if i >= n:
            break
        out.append(tr._batch_arrays(b, b.src, neg_dst))
    return out


@one_thread
def memory_chain(mesh=None, n: int = 5) -> dict:
    """TGN with its seed-0 parameters fixed: ``eval_step`` over the first
    ``n`` train batches (each commits), then the whole state (gathered
    under a mesh) as numpy."""
    tr = trainer("TGN", mesh)
    state = tr.init_state()
    for arrays in seeded_batches(tr, n):
        state = tr.eval_step(tr.train_csr, arrays, state=state)[2]
    return {k: v.numpy() for k, v in tr.host_state(state)._asdict().items()}


def guard_counts(mesh=None, extra_nodes: int = 0) -> dict:
    """Collective bytes of one TGN train step and one eval step, on the
    fixture with ``extra_nodes`` more (featureless, never touched) nodes;
    then, separately, of gathering the state for a checkpoint."""
    import dataclasses

    from dyglib_tpu_torch.parallel import collective_counts, reset_collective_counts

    d = fixture_data()
    feats = d.node_raw_features
    d = dataclasses.replace(d, node_raw_features=np.concatenate(
        [feats, np.zeros((extra_nodes, feats.shape[1]), feats.dtype)]))
    tr = trainer("TGN", mesh, data=d)
    arrays = seeded_batches(tr, 1)[0]
    reset_collective_counts()
    _, _, state = tr.train_step(arrays, state=tr.init_state())
    tr.eval_step(tr.full_csr, arrays, state=state)
    step = collective_counts()
    reset_collective_counts()
    tr.host_state(state)
    return {"step": step, "checkpoint": collective_counts(), "num_nodes": d.num_nodes}


def memory_checks(rank, world) -> dict:
    """The memory file's checks on a (world, 1) mesh."""
    from dyglib_tpu_torch.models.memory_model import gather_state, shard_state, state_rows
    from dyglib_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world)
    out = {"chain": memory_chain(mesh), "train": train_case("TGN", mesh),
           "guard": [guard_counts(mesh, 0), guard_counts(mesh, 1000)]}
    # a whole state sharded and gathered back is itself
    tr = trainer("TGN", mesh)
    rows = state_rows(tr.data.num_nodes)
    g = torch.Generator().manual_seed(1)
    whole = tr.backbone.init_state(tr.tables)._replace(
        memory=torch.randn((rows, 172), generator=g),
        last_update=torch.randint(0, 1000, (rows,), generator=g, dtype=torch.int32))
    back = gather_state(shard_state(whole, mesh), mesh, rows)
    out["round_trip"] = all(torch.equal(a, b) for a, b in zip(whole, back))
    out["shard_rows"] = tr.init_state().memory.shape[0]
    # memory order is checked on the shards: a sweep passes, a batch
    # committed twice moves clocks backwards on the shard that owns them
    tr = trainer("TGN", mesh, check_memory_order=True)
    tr.train_epoch()
    batches = seeded_batches(tr, 3)
    state = tr.init_state()
    for arrays in batches:
        state = tr.eval_step(tr.train_csr, arrays, state=state)[2]
    clocks = tr._clocks(state)
    late = tr.eval_step(tr.train_csr, batches[0], state=state)[2]
    from dyglib_tpu_torch.models.memory_model import memory_order_violations

    out["violations"] = memory_order_violations(*clocks, late)
    return out


@one_thread
def quad_embeddings(tr, batch: int = 0) -> np.ndarray:
    """The eval-mode quad embeddings of train batch ``batch`` (this rank's
    rows under a mesh: all of them when the data axis has one rank)."""
    arrays = seeded_batches(tr, batch + 1)[batch]
    tr.model.eval()
    with torch.no_grad():
        return tr._embed(tr._sample(tr.train_csr, arrays, "quad"), "quad").numpy()


def ulysses_checks(rank, world) -> dict:
    """DyGFormer with its joint tokens sharded over a model axis of all
    the ranks: the forward under fixed parameters, training, the counts."""
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.parallel import collective_counts, make_mesh, reset_collective_counts
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    mesh = make_mesh(world, model_parallelism=world)
    reset_collective_counts()
    out = {"embeddings": quad_embeddings(trainer("DyGFormer-ulysses", mesh))}
    out["forward_collectives"] = collective_counts()
    reset_collective_counts()
    out["train"] = train_case("DyGFormer-ulysses", mesh)
    out["collectives"] = collective_counts()
    try:
        LinkPredictionTrainer(DyGFormer(num_heads=1, sequence_axis="model"), fixture_data(),
                              TrainConfig(), device="cpu", mesh=mesh)
        out["odd_heads"] = "accepted"
    except ValueError as e:
        out["odd_heads"] = str(e)
    return out


@one_thread
def remat_step(mesh=None, remat: bool = False, compute_dtype: str = "float32") -> dict:
    """One train step of a 2-layer DyGFormer at dropout 0.1 (Ulysses over
    the model axis under ``mesh``) from the seed-0 parameters on the first
    seeded batch: its loss, the parameter gradients, the dropout
    generator's state after it and the eval-mode quad embeddings before it."""
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import DyGFormer
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig

    data = fixture_data()
    backbone = DyGFormer(max_input_sequence_length=16, patch_size=2, num_layers=2, dropout=0.1,
                         sequence_axis=None if mesh is None else "model", remat=remat,
                         compute_dtype=compute_dtype)
    tr = LinkPredictionTrainer(backbone, data, TrainConfig(learning_rate=1e-3), device="cpu",
                               mesh=mesh)
    tr.train_neg = NegativeEdgeSampler(data.train.src, data.train.dst, seed=3)
    tr.init_params(0)
    embeddings = quad_embeddings(tr)
    loss, _ = tr.train_step(seeded_batches(tr, 1)[0])
    return {"loss": float(loss), "embeddings": embeddings,
            "grads": {k: p.grad.numpy().copy() for k, p in tr.model.named_parameters()
                      if p.grad is not None},
            "generator": tr.dropout_gen.get_state().numpy()}


def remat_ulysses_checks(rank, world) -> dict:
    """``remat_step`` with and without remat, in f32 and bf16, with the
    joint tokens sharded over a model axis of all the ranks, and each
    step's collective counts."""
    from dyglib_tpu_torch.parallel import collective_counts, make_mesh, reset_collective_counts

    mesh = make_mesh(world, model_parallelism=world)
    out = {}
    for remat in (False, True):
        for cd in ("float32", "bfloat16"):
            reset_collective_counts()
            res = remat_step(mesh, remat, cd)
            res["collectives"] = collective_counts()
            out[(remat, cd)] = res
    return out


def setup_cases(rank, world, cases, data_root) -> list:
    """``runners.setup_parallelism`` on each flag list (this rank's
    ``--process_id`` substituted for RANK): the mesh's shape (None for no
    mesh) and whether this rank leads."""
    from dyglib_tpu_torch.configs import get_link_prediction_args
    from dyglib_tpu_torch.runners import setup_parallelism

    out = []
    for flags in cases:
        argv = ["--model_name", "TGAT", "--dataset_name", "synthetic", "--data_root", data_root,
                "--device", "cpu"] + [str(rank) if f == "RANK" else f for f in flags]
        mesh, lead = setup_parallelism(get_link_prediction_args(argv))
        out.append((None if mesh is None else mesh.shape, lead))
    return out
