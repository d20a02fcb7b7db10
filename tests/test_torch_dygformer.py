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
