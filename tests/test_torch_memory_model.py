"""The memory models (TGN, DyRep, JODIE) in the port against the JAX package on the CPU.

  * ``FusedGRUCell`` and ``FusedRNNCell`` with the JAX cells' parameters:
    within 1e-6;
  * ``compute_src_dst_node_time_shifts``, ``segment_roles`` and
    ``memory_order_violations``: exact;
  * ``transfer.from_jax_params`` carries each model's tree (the cell's
    wi/wh/bi/bh as they are, JODIE's time projection, the attention, merge
    and time-encoder modules) into the port's net, every tensor equal;
  * ``MemoryModel.sample``: bitwise equal hop tensors;
  * the embeddings of each model against the lazy view of a state with
    pending messages, with the JAX parameters: within 1e-5, kernel branch
    and plain branch (TGN's and DyRep's attention runs the fused temporal
    attention's plain version on the CPU; the JAX module its XLA path);
  * two ``forward_and_maybe_commit`` cycles on batches with duplicate
    src ids and src/dst overlaps, each side threading its own state: the
    output embeddings (DyRep's are the updated memories) and ``memory``
    and ``msg`` within 1e-5, ``last_update``, ``msg_time`` and
    ``msg_valid`` exact after each;
  * ``view_rows`` equals ``memory_view`` at those rows, padded batch rows
    leave the state untouched, DyRep's outputs are the updated memories.

Small widths (node, edge and memory width 12, Dt = 10, K = 5, B = 16) on a
90-node stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.models.memory_model import MemoryModel as JaxMemoryModel
from dyglib_tpu.models.memory_model import MemoryState as JaxState
from dyglib_tpu.models.memory_model import (
    compute_src_dst_node_time_shifts as jax_time_shifts,
)
from dyglib_tpu.models.memory_model import memory_order_violations as jax_violations
from dyglib_tpu.models.memory_model import segment_roles as jax_segment_roles
from dyglib_tpu.nn.modules import FusedGRUCell as JaxGRU
from dyglib_tpu.nn.modules import FusedRNNCell as JaxRNN
from dyglib_tpu_torch import ops
from dyglib_tpu_torch.data import synthetic_link_prediction_data
from dyglib_tpu_torch.graph import build_temporal_csr
from dyglib_tpu_torch.models import (
    FeatureTables,
    MemoryModel,
    MemoryState,
    compute_src_dst_node_time_shifts,
    memory_order_violations,
    segment_roles,
)
from dyglib_tpu_torch.nn import FusedGRUCell, FusedRNNCell
from dyglib_tpu_torch.transfer import from_jax_params, module_state_dict

FEAT, DT, K, B = 12, 10, 5, 16
MODELS = ["TGN", "DyRep", "JODIE"]


@pytest.fixture(scope="module")
def small():
    data = synthetic_link_prediction_data(
        num_src=60, num_dst=30, num_edges=1500, edge_feat_dim=FEAT, node_feat_scale=1.0, seed=3
    )
    data = dataclasses.replace(
        data,
        node_raw_features=np.ascontiguousarray(data.node_raw_features[:, :FEAT]),
        edge_raw_features=np.ascontiguousarray(data.edge_raw_features[:, :FEAT]),
    )
    jax_tables = JaxTables(node=jnp.asarray(data.node_raw_features),
                           edge=jnp.asarray(data.edge_raw_features))
    tables = FeatureTables(node=torch.from_numpy(data.node_raw_features),
                           edge=torch.from_numpy(data.edge_raw_features))
    jax_csr = jax_build_csr(data.full, num_nodes=data.num_nodes)
    csr = build_temporal_csr(data.full, num_nodes=data.num_nodes)
    shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
    return data, jax_tables, tables, jax_csr, csr, shifts


@pytest.fixture(scope="module")
def models(small):
    """Per model: (JAX adapter, its seed-1 parameters as numpy, the port's
    adapter, the port's net holding those parameters)."""
    _, jax_tables, _, jax_csr, _, shifts = small
    out = {}
    for name in MODELS:
        kw = dict(model_name=name, memory_dim=FEAT, num_neighbors=K, num_layers=1,
                  num_heads=2, dropout=0.0, time_feat_dim=DT, time_shifts=shifts)
        jm = JaxMemoryModel(**kw)
        params = jax.tree_util.tree_map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jax_tables, jax_csr))
        pm = MemoryModel(**kw)
        net = pm.build(FEAT, FEAT, torch.Generator().manual_seed(0)).eval()
        net.load_state_dict(module_state_dict(params))
        out[name] = (jm, params, pm, net)
    return out


def _random_state(seed, rows, msg_dim, t_max):
    """A numpy state with pending messages on about half the nodes; the
    dump row (the last) zero."""
    rng = np.random.RandomState(seed)
    lu = rng.randint(0, t_max // 2, rows).astype(np.int32)
    arrays = [
        rng.randn(rows, FEAT).astype(np.float32), lu,
        rng.randn(rows, msg_dim).astype(np.float32),
        (lu + rng.randint(0, t_max // 4, rows)).astype(np.int32), rng.rand(rows) < 0.5,
    ]
    for a in arrays:
        a[-1] = 0
    return arrays


def _states(arrays):
    return (JaxState(*(jnp.asarray(a) for a in arrays)),
            MemoryState(*(torch.from_numpy(np.array(a)) for a in arrays)))


def _assert_state_close(ours: MemoryState, ref, where=""):
    for f in MemoryState._fields:
        got, want = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")


# ---- cells, time shifts, roles, violations
@pytest.mark.parametrize("cell", ["gru", "rnn"])
def test_cells_match_jax(cell):
    d_in, hid, rows = 23, 9, 31
    rng = np.random.RandomState(4)
    h, x = rng.randn(rows, hid).astype(np.float32), rng.randn(rows, d_in).astype(np.float32)
    jax_cell = (JaxGRU if cell == "gru" else JaxRNN)(features=hid)
    params = jax_cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    want = np.asarray(jax_cell.apply(params, jnp.asarray(h), jnp.asarray(x)))
    ours = (FusedGRUCell if cell == "gru" else FusedRNNCell)(
        d_in, hid, torch.Generator().manual_seed(0))
    sd = module_state_dict(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ours.state_dict().items()}
    ours.load_state_dict(sd)
    with torch.no_grad():
        got = ours(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_time_shifts_match_jax_exactly(small, link_data):
    for d in (small[0], link_data):
        src, dst, ts = d.train.src, d.train.dst, d.train.ts
        assert compute_src_dst_node_time_shifts(src, dst, ts) == jax_time_shifts(src, dst, ts)


@pytest.mark.parametrize("layout", [("src", "dst", "dst"), ("src", "dst", "src", "dst"),
                                    ("dst",), ("src", "src", "dst")])
def test_segment_roles_match_jax(layout):
    got = segment_roles(7, layout)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_segment_roles(7, layout)))
    with pytest.raises(ValueError):
        segment_roles(2, ("src", "neg"))


def test_memory_order_violations_match_jax(small):
    rows = 24
    arrays = _random_state(0, rows, 3, 1000)
    lu, mt = arrays[1], arrays[3]
    for shift_lu, shift_mt, bad in ((5, 3, ()), (0, 0, ()), (5, 3, (2, 7)), (-1, 0, ())):
        new = [a.copy() for a in arrays]
        new[1], new[3] = lu + shift_lu, mt + shift_mt
        for i in bad:
            new[1][i] = -1
            new[3][i] = -1
        new[1][-1] = -5  # the dump row is exempt
        jstate, state = _states(new)
        n = memory_order_violations(lu, mt, state)
        assert n == jax_violations(lu, mt, jstate)
        assert n == (2 * len(bad) if shift_lu >= 0 else rows - 1)


# ---- parameters, sampling and embeddings
@pytest.mark.parametrize("name", MODELS)
def test_transfer_carries_each_memory_model(models, name):
    jm, params, pm, _ = models[name]
    head = {"fc1": {"kernel": np.ones((2, 3), np.float32), "bias": np.zeros(3, np.float32)}}
    got = from_jax_params({"backbone": params, "head": head})
    net = pm.build(FEAT, FEAT, torch.Generator().manual_seed(9))
    assert set(got["backbone"]) == set(net.state_dict())
    net.load_state_dict(got["backbone"])  # strict: names and shapes
    tree = params["params"]
    cell = net.memory_cell
    for k in ("wi", "wh", "bi", "bh"):  # the cell's tensors as they are
        np.testing.assert_array_equal(getattr(cell, k).detach().numpy(), tree["memory_cell"][k])
    gates = 3 if name == "TGN" else 1
    assert cell.wi.shape == (2 * FEAT + DT + FEAT, gates * FEAT)
    if name == "JODIE":
        np.testing.assert_array_equal(net.time_projection.weight.detach().numpy(),
                                      tree["time_projection"]["kernel"].T)
        assert "temporal_conv_0" not in tree
    else:
        conv = tree["temporal_conv_0"]
        np.testing.assert_array_equal(net.temporal_conv_0.key_projection.weight.detach().numpy(),
                                      conv["key_projection"]["kernel"].T)
        np.testing.assert_array_equal(net.merge_0.fc2.bias.detach().numpy(),
                                      tree["merge_0"]["fc2"]["bias"])
    np.testing.assert_array_equal(net.time_encoder.w.detach().numpy(), tree["time_encoder"]["w"])


def _queries(data, n=B):
    """The triple of the first val edges: [src || dst || neg_dst]."""
    rng = np.random.RandomState(0)
    src, dst = data.val.src[:n], data.val.dst[:n]
    ids = np.concatenate([src, dst, rng.choice(np.unique(data.full.dst), n)]).astype(np.int32)
    ts = np.tile(data.val.ts[:n], 3).astype(np.int32)
    return ids, ts


def _sample_both(small, jm, pm, ids, ts):
    _, _, _, jax_csr, csr, _ = small
    jin = jax.jit(jm.sample)(jax_csr, jnp.asarray(ids), jnp.asarray(ts), jax.random.PRNGKey(0))
    pin = pm.sample(csr, torch.from_numpy(ids), torch.from_numpy(ts))
    return jin, pin


@pytest.mark.parametrize("name", MODELS)
def test_sample_matches_jax(small, models, name):
    jm, _, pm, _ = models[name]
    ids, ts = _queries(small[0])
    jin, pin = _sample_both(small, jm, pm, ids, ts)
    for field in ("ids4", "ts4"):
        np.testing.assert_array_equal(getattr(pin, field).numpy(), np.asarray(getattr(jin, field)))
    for field in ("hop_ids", "hop_eids", "hop_ts", "hop_mask"):
        ours, ref = getattr(pin, field), getattr(jin, field)
        # JODIE samples nothing: its levels are the queries alone
        levels = (field in ("hop_ids", "hop_ts")) + (name != "JODIE")
        assert len(ours) == len(ref) == levels
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", MODELS)
def test_embed_matches_jax(small, models, name):
    data, jax_tables, tables, *_ = small
    jm, params, pm, net = models[name]
    ids, ts = _queries(data)
    jin, pin = _sample_both(small, jm, pm, ids, ts)
    roles = ("src", "dst", "dst")
    jin = jin._replace(roles=jax_segment_roles(B, roles))
    pin = pin._replace(roles=segment_roles(B, roles))
    rows = pm.init_state(tables).memory.shape[0]
    jstate, state = _states(_random_state(1, rows, 2 * FEAT + DT + FEAT, int(ts.max())))
    want = np.asarray(jm.apply(params, jax_tables, jin, state=jstate))
    before = ops.launch_counts()
    with torch.no_grad():
        got = net(tables, state, pin)
        net.use_kernels = False
        plain = net(tables, state, pin)
    net.use_kernels = True
    assert ops.launch_counts() == before  # CPU tensors: the plain versions
    assert got.shape == (3 * B, FEAT) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(plain, got, atol=1e-6, rtol=0)
    if name == "JODIE":  # the layout matters; without roles only a quad's row count passes
        flipped = net(tables, state, pin._replace(roles=~pin.roles)).detach()
        assert (flipped - got).abs().max() > 1e-3
        with pytest.raises(ValueError, match="roles"):
            net(tables, state, pin._replace(ids4=pin.ids4[1:], ts4=pin.ts4[1:], roles=None))


# ---- commits
def _commit_batches(data):
    """Two batches of B edges with duplicate src ids and nodes on both
    sides (a node is the src of one edge and the dst of another), time
    keys nondecreasing within and across batches, the last two rows of
    the second batch padded (valid False, real ids)."""
    src, dst, ts, eid = data.train.src, data.train.dst, data.train.ts, data.train.eid
    out = []
    for start in (400, 400 + B):
        s = src[start:start + B].astype(np.int32).copy()
        d = dst[start:start + B].astype(np.int32).copy()
        s[3] = s[1]  # duplicate src ids
        s[9] = s[1]
        d[5] = s[2]  # a src that is also a dst
        s[11] = d[4]  # a dst that is also a src
        valid = np.ones(B, bool)
        if start > 400:
            valid[-2:] = False
        out.append((s, d, ts[start:start + B].astype(np.int32),
                    eid[start:start + B].astype(np.int32), valid))
    return out


def _cycle(small, jm, params, pm, net, jstate, state, batch):
    """One forward_and_maybe_commit on each side -> JAX's (embs, state), ours."""
    _, jax_tables, tables, jax_csr, csr, _ = small
    s, d, ts, eid, valid = batch
    ids = np.concatenate([s, d, s, d])
    jin = jax.jit(jm.sample)(jax_csr, jnp.asarray(ids), jnp.asarray(np.tile(ts, 4)),
                             jax.random.PRNGKey(0))
    jout = jax.jit(jm.forward_and_maybe_commit)(
        params, jax_tables, jstate, jin, *(jnp.asarray(a) for a in batch))
    pin = pm.sample(csr, torch.from_numpy(ids), torch.from_numpy(np.tile(ts, 4)))
    with torch.no_grad():
        pout = pm.forward_and_maybe_commit(net, tables, state, pin,
                                           *(torch.from_numpy(a) for a in batch))
    return jout, pout


@pytest.mark.parametrize("name", MODELS)
def test_two_commit_cycles_match_jax(small, models, name):
    data, _, tables, *_ = small
    jm, params, pm, net = models[name]
    rows = pm.init_state(tables).memory.shape[0]
    arrays = _random_state(2, rows, 2 * FEAT + DT + FEAT, int(data.train.ts[400]))
    jstate, state = _states(arrays)
    start = [a.copy() for a in arrays]
    for step, batch in enumerate(_commit_batches(data)):
        (jemb, jstate), (emb, state) = _cycle(small, jm, params, pm, net, jstate, state, batch)
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-5, rtol=0)
        _assert_state_close(state, jstate, f"{name} cycle {step}")
        touched = np.concatenate([batch[0][batch[4]], batch[1][batch[4]]])
        assert state.msg_valid[touched].all()
    # the input state is never modified
    for a, f in zip(start, MemoryState._fields):
        np.testing.assert_array_equal(a, arrays[MemoryState._fields.index(f)])


@pytest.mark.parametrize("name", MODELS)
def test_padded_rows_leave_the_state_untouched(small, models, name):
    """Whatever a padded row holds, the state is the same bit for bit; it is
    the commit of the valid rows alone (within GEMM rounding: the cell runs
    on another number of rows); a batch of padded rows only changes
    nothing, the dump row included."""
    data, _, tables, _, csr, _ = small
    _, _, pm, net = models[name]
    rows = pm.init_state(tables).memory.shape[0]
    _, state = _states(_random_state(3, rows, 2 * FEAT + DT + FEAT, int(data.train.ts[400])))
    s, d, ts, eid, valid = _commit_batches(data)[1]
    n = int(valid.sum())
    t = lambda *a: [torch.from_numpy(x) for x in a]
    emb = torch.randn(2 * B, FEAT, generator=torch.Generator().manual_seed(0))
    full = pm.commit(net, tables, state, *t(s, d, ts, eid, valid), emb[:B], emb[B:])
    s2, d2, ts2, eid2 = s.copy(), d.copy(), ts.copy(), eid.copy()
    s2[n:], d2[n:], ts2[n:], eid2[n:] = d[0], 0, ts[-1] + 7, 1  # other padding
    emb2 = emb.clone()
    emb2[n:B] = 5.0
    other = pm.commit(net, tables, state, *t(s2, d2, ts2, eid2, valid), emb2[:B], emb2[B:])
    cut = pm.commit(net, tables, state, *t(s[:n], d[:n], ts[:n], eid[:n], valid[:n]),
                    emb[:n], emb[B:B + n])
    for f in MemoryState._fields:
        assert torch.equal(getattr(full, f), getattr(other, f)), f
        torch.testing.assert_close(getattr(full, f), getattr(cut, f), atol=1e-6, rtol=0, msg=f)
    none = pm.commit(net, tables, state, *t(s, d, ts, eid, np.zeros(B, bool)), emb[:B], emb[B:])
    for f in MemoryState._fields:
        assert torch.equal(getattr(none, f), getattr(state, f)), f


@pytest.mark.parametrize("name", MODELS)
def test_view_rows_is_the_memory_view_at_those_rows(small, models, name):
    data, _, tables, *_ = small
    _, _, pm, net = models[name]
    rows = pm.init_state(tables).memory.shape[0]
    _, state = _states(_random_state(4, rows, 2 * FEAT + DT + FEAT, 10**6))
    pick = torch.from_numpy(np.random.RandomState(1).randint(0, rows, 40).astype(np.int32))
    with torch.no_grad():
        mem_all, lu_all = net.memory_view(state)
        mem, lu = net.view_rows(state, pick)
    torch.testing.assert_close(mem, mem_all[pick.long()], atol=1e-6, rtol=0)
    assert torch.equal(lu, lu_all[pick.long()])
    pending = state.msg_valid[pick.long()]
    assert pending.any() and (~pending).any()
    assert torch.equal(mem[~pending], state.memory[pick.long()][~pending])


def test_dyrep_outputs_are_the_updated_memories(small, models):
    data, _, tables, *_ = small
    _, _, pm, net = models["DyRep"]
    ids, ts = _queries(data)
    inputs = pm.sample(small[4], torch.from_numpy(ids), torch.from_numpy(ts))
    rows = pm.init_state(tables).memory.shape[0]
    _, state = _states(_random_state(5, rows, 2 * FEAT + DT + FEAT, int(ts.max())))
    with torch.no_grad():
        out, raw = pm.embed_quad(net, tables, state, inputs)
        assert torch.equal(out, net.view_rows(state, inputs.ids4)[0])
        assert torch.equal(raw, net(tables, state, inputs))
    assert (out - raw).abs().max() > 1e-3
