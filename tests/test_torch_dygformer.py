"""Port DyGFormer forward against the JAX package on the CPU.

The JAX parameters (``DyGFormer.init``) go through ``from_jax_params``;
both networks then embed the same sampled inputs, dropout off, f32, in
quad and triple modes, at patch 1 and patch 4. On the CPU the kernel
wrappers (``use_kernels=True``) take their plain versions, so both settings
of ``use_kernels`` are held to JAX.

Tolerance: embeddings within 1e-5 absolute (they are O(1)). Both sides run
the same f32 math; the two frameworks order the sums of their matmuls,
einsums, LayerNorms and means differently, which moves each O(1) result by
a few f32 ulps (~1e-6 observed), and nothing in the network amplifies that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyglib_tpu.graph import build_temporal_csr as jax_build_csr
from dyglib_tpu.graph.csr import time_keys
from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.models import FeatureTables as JaxTables
from dyglib_tpu.nn.modules import MergeLayer as JaxMergeLayer
from dyglib_tpu_torch.models import DyGFormer, DyGFormerInputs, FeatureTables
from dyglib_tpu_torch.nn import MergeLayer
from dyglib_tpu_torch.transfer import from_jax_params

ATOL = 1e-5


@pytest.fixture(scope="module")
def env(link_data):
    d = link_data
    csr = jax_build_csr(d.train, num_nodes=d.num_nodes)
    jt = JaxTables(node=jnp.asarray(d.node_raw_features), edge=jnp.asarray(d.edge_raw_features))
    tt = FeatureTables(
        node=torch.from_numpy(d.node_raw_features), edge=torch.from_numpy(d.edge_raw_features)
    )
    return d, csr, jt, tt


@pytest.fixture(scope="module", params=[1, 4], ids=["patch1", "patch4"])
def models(request, env):
    d, csr, jt, _ = env
    kw = dict(max_input_sequence_length=32, patch_size=request.param, num_layers=2)
    jm = JaxDyGFormer(**kw, use_time_kernel=False, gelu_approximate=False)
    params = {
        "backbone": jm.init(jax.random.PRNGKey(0), jt, csr),
        "head": JaxMergeLayer(hidden_dim=172, output_dim=1).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 172)), jnp.zeros((1, 172))
        ),
    }
    params = jax.tree_util.tree_map(np.asarray, params)
    return kw, jm, params


def test_from_jax_params_covers_every_parameter(models):
    kw, _, params = models
    sd = from_jax_params(params)
    gen = torch.Generator().manual_seed(0)
    net = DyGFormer(**kw).build(172, 172, gen)
    head = MergeLayer(344, 172, 1, gen)
    for module, got in ((net, sd["backbone"]), (head, sd["head"])):
        want = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k
    jw = params["backbone"]["params"]["time_encoder"]["w"]
    assert jw.shape == (1, 100)
    np.testing.assert_array_equal(sd["backbone"]["time_encoder.w"].numpy(), jw)
    np.testing.assert_array_equal(
        sd["backbone"]["transformer_0.q_proj.weight"].numpy(),
        params["backbone"]["params"]["transformer_0"]["q_proj"]["kernel"].T,
    )


def test_jax_checkpoint_loads_into_port(models, tmp_path):
    """A pickle checkpoint written by the JAX package loads with the port's
    ``load_checkpoint`` and transfers to the same state dicts as its params."""
    from dyglib_tpu.train.checkpoints import save_checkpoint

    from dyglib_tpu_torch.train import load_checkpoint

    _, _, params = models
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, params, extra={"epoch": 3})
    ck = load_checkpoint(path)
    assert ck["extra"] == {"epoch": 3}
    got, want = from_jax_params(ck["params"]), from_jax_params(params)
    for part in ("backbone", "head"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="directory"):
        load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("triple", [False, True], ids=["quad", "triple"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "wrappers"])
def test_forward_matches_jax(env, models, triple, use_kernels):
    d, csr, jt, tt = env
    kw, jm, params = models
    b = 16
    s, t = d.train.src[100 : 100 + b], d.train.dst[100 : 100 + b]
    ts = time_keys(d.train.ts[100 : 100 + b])
    if triple:
        ids, tsx = np.concatenate([s, t, t[::-1]]), np.tile(ts, 3)
    else:
        ids, tsx = np.concatenate([s, t, s[::-1], t[::-1]]), np.tile(ts, 4)
    inputs = jm.sample(
        csr, jnp.asarray(ids, jnp.int32), jnp.asarray(tsx, jnp.int32), jax.random.PRNGKey(1)
    )
    ref = np.asarray(jm.apply(params["backbone"], jt, inputs, triple=triple))

    gen = torch.Generator().manual_seed(0)
    net = DyGFormer(**kw, use_kernels=use_kernels).build(172, 172, gen)
    net.load_state_dict(from_jax_params(params)["backbone"])
    net.eval()
    t_in = DyGFormerInputs(*(torch.from_numpy(np.array(x)) for x in inputs[:4]))
    with torch.no_grad():
        out = net(tt, t_in, triple=triple).numpy()
    assert out.shape == ref.shape == (4 * b, 172)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("patch", [1, 4])
def test_frozen_channels_take_the_patch_kernel_only_above_patch_1(monkeypatch, compute_dtype,
                                                                  mode, patch):
    """The JAX package's rule (``dyglib_tpu/models/dygformer.py``: its patch
    kernel only at patch > 1): with ``use_kernels`` the port's DyGFormer calls
    the patch-projection wrapper for the node and edge channels at patch 4,
    never at patch 1, where the channel is a linear (the plain path's, bit for
    bit); the time channel's wrapper runs at both, in f32 and bf16, in an
    eval forward and in a train step."""
    import dyglib_tpu_torch.models.dygformer as dyg_module

    calls = {"patch_projection": 0, "time_channel_projection": 0}
    for name in calls:
        real = getattr(dyg_module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(dyg_module, name, spy)
    rng = np.random.RandomState(3)
    m, lp, feat, n_nodes, n_edges = 3 * 4, 8, 12, 30, 60
    seq_ids = rng.randint(1, n_nodes, (m, lp)).astype(np.int32)
    seq_ids[:, 5:] = 0
    inputs = DyGFormerInputs(*(torch.from_numpy(a) for a in (
        seq_ids, np.where(seq_ids > 0, rng.randint(1, n_edges, (m, lp)), 0).astype(np.int32),
        rng.randint(0, 1000, (m, lp)).astype(np.int32), np.full(m, 2000, np.int32))))
    node, edge = rng.randn(n_nodes, feat), rng.randn(n_edges, feat)
    node[0] = edge[0] = 0.0
    tables = FeatureTables(torch.from_numpy(node.astype(np.float32)),
                           torch.from_numpy(edge.astype(np.float32)))
    outs = {}
    for use_kernels in (True, False):
        net = DyGFormer(max_input_sequence_length=lp, patch_size=patch, channel_embedding_dim=8,
                        time_feat_dim=8, num_layers=1, dropout=0.1, compute_dtype=compute_dtype,
                        use_kernels=use_kernels).build(feat, feat, torch.Generator().manual_seed(0))
        before = dict(calls)
        if mode == "eval":
            with torch.no_grad():
                out = net.eval()(tables, inputs, triple=True)
        else:
            out = net.train()(tables, inputs, triple=True,
                              dropout_gen=torch.Generator().manual_seed(5))
            out.float().sum().backward()
            assert all(p.grad is not None for p in net.parameters() if p.requires_grad)
        launched = {k: calls[k] - before[k] for k in calls}
        if use_kernels:
            assert launched == {"patch_projection": 0 if patch == 1 else 2,
                                "time_channel_projection": 1}
        else:
            assert launched == {"patch_projection": 0, "time_channel_projection": 0}
        outs[use_kernels] = out.detach()
    if patch == 1:
        torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def test_chip_smoke_expects_no_patch_kernel_at_patch_1():
    """chip_smoke.py's launch expectations follow the same rule: DyGFormer
    32/1 (wikipedia, the node-class and mesh backbone) launches the time
    channel and the co-occurrence counts and no patch projection, CanParl
    (patch 64) all three and their backwards, in f32 and bf16."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.dygformer_kernels(1) == ["time_channel", "cooccurrence"]
    assert smoke.dygformer_kernels(1, train=True) == ["time_channel", "cooccurrence",
                                                      "time_channel_bwd"]
    assert smoke.dygformer_kernels(64, train=True, bf16=True) == [
        "time_channel_bf16", "cooccurrence", "patch_projection_bf16", "time_channel_bf16_bwd",
        "patch_projection_bf16_bwd"]
    assert "patch_projection" not in smoke.NODECLS_MODELS["DyGFormer"]
    assert not any("patch" in k for k in smoke.MESH_KERNELS["DyGFormer"])
    fwd, bwd = smoke.BF16_PATH_KERNELS["DyGFormer wikipedia"]
    assert not any("patch" in k for k in fwd + bwd)
    fwd, bwd = smoke.BF16_PATH_KERNELS["DyGFormer CanParl"]
    assert "patch_projection_bf16" in fwd and "patch_projection_bf16_bwd" in bwd
