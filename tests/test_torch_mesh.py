"""visrag_tpu_torch.mesh against visrag_tpu.mesh: the fill rule and its
errors, the multi-host layout, the FSDP and tensor-parallel rules on the
port's models, and (4 gloo ranks, one job) the DeviceMesh's coordinates,
groups and batch split against the JAX mesh's device order and
batch_sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.config import MeshConfig as JMeshConfig
from visrag_tpu.mesh import batch_sharding as jbatch_sharding
from visrag_tpu.mesh import build_mesh as jbuild_mesh
from visrag_tpu.mesh import fsdp_param_spec as jfsdp_spec
from visrag_tpu.mesh import multihost_mesh_config as jmultihost
from visrag_tpu.mesh import tp_param_spec as jtp_spec
from visrag_tpu_torch import mesh as M
from visrag_tpu_torch.config import MeshConfig
from torch_dist_workers import mesh_layout, spawn


LAYOUTS = [dict(replica=2, data=2), dict(data=2, seq=2),
           dict(data=-1, seq=4), dict(model=2, data=-1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    (and this file's spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_shape(kw, n):
    mesh = jbuild_mesh(JMeshConfig(**kw), devices=jax.devices()[:n])
    return dict(mesh.shape)


@pytest.mark.parametrize("kw,n", [(dict(), 8), (dict(data=2, seq=4), 8),
                                  (dict(replica=2, data=-1), 8),
                                  (dict(data=-1, seq=-1), 4),
                                  (dict(replica=-1, data=2, model=2), 8),
                                  (dict(data=1), 1)])
def test_fill_rule_matches_jax(kw, n):
    assert M.mesh_shape(MeshConfig(**kw), n) == _jax_shape(kw, n)


@pytest.mark.parametrize("kw,n", [(dict(data=3), 8),
                                  (dict(data=3, seq=-1), 8),
                                  (dict(data=2, seq=2), 8)])
def test_fill_rule_errors_as_jax(kw, n):
    with pytest.raises(ValueError) as want:
        _jax_shape(kw, n)
    with pytest.raises(ValueError) as got:
        M.mesh_shape(MeshConfig(**kw), n)
    assert str(got.value) == str(want.value)


def test_multihost_mesh_config_math():
    """tests/test_parallel.py's multi-host checks: the replica axis spans
    the nodes; an explicit replica must hold whole nodes; no coordinator
    → a one-process no-op."""
    cfg = MeshConfig()
    assert M.multihost_mesh_config(cfg, 1) is cfg
    assert M.multihost_mesh_config(cfg, 4).replica == 4
    assert M.multihost_mesh_config(MeshConfig(replica=4), 2).replica == 4
    with pytest.raises(ValueError):
        M.multihost_mesh_config(MeshConfig(replica=3), 2)
    for n in (1, 2, 4):
        for rep in (1, -1, 2, 4):
            try:
                want = jmultihost(JMeshConfig(replica=rep), n).replica
            except ValueError:
                with pytest.raises(ValueError):
                    M.multihost_mesh_config(MeshConfig(replica=rep), n)
                continue
            assert M.multihost_mesh_config(
                MeshConfig(replica=rep), n).replica == want
    assert M.mesh_shape(M.multihost_mesh_config(MeshConfig(), 4), 8) == \
        {"replica": 4, "data": 2, "seq": 1, "model": 1}
    assert M.init_distributed() == (0, 1)
    assert M.num_nodes_of_job() == 1
    with pytest.raises(ValueError, match="no coordinator"):
        M.init_distributed(num_processes=2)
    with pytest.raises(ValueError, match="process id"):
        M.init_distributed("localhost:1")
    with pytest.raises(RuntimeError, match="process group"):
        M.build_mesh(MeshConfig(data=1))


def _port_models():
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
    return {"visrag_ret": VisRAGRet(VisRAGRetConfig.tiny()),
            "qwen25_vl": Qwen25VL(Qwen25VLConfig.tiny())}


@pytest.mark.parametrize("n_data", [2, 3, 4])
def test_fsdp_rule_matches_jax_on_port_models(n_data):
    """Every parameter of the port's tiny VisRAG-Ret and Qwen2.5-VL: the
    port's spec equals the JAX rule's at min_size 256 (the tiny models'
    parameters are all under the default 65,536) and at the default."""
    jmesh = jbuild_mesh(JMeshConfig(data=n_data),
                        devices=jax.devices()[:n_data])
    sharded = 0
    for model in _port_models().values():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            for min_size in (256, 2 ** 16):
                got = M.fsdp_param_spec(shape, {"data": n_data}, min_size)
                assert got == tuple(jfsdp_spec(shape, jmesh, min_size)), name
                sharded += M.DATA in got
            assert M.fsdp_shard_dim(shape, {"data": n_data}) == 0
    assert sharded > 20


def test_tp_rule_matches_jax_on_port_models():
    """The tensor-parallel rule at model = 2 and 4: over the tiny
    Qwen2.5-VL's parameters, the port's placements (by its HF names) are
    the JAX rule's on the JAX model's parameters (its own names, shapes
    from jax.eval_shape of its init with one image) shape for shape: the
    same multiset of (shape, spec). The port reads the JAX names attn_qkv
    / attn_proj in the HF paths attn.qkv / attn.proj, and an
    nn.Embedding's weight as the JAX embedding."""
    from PIL import Image
    from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
    from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JQwenConfig
    from visrag_tpu.preprocess import qwen_vision as jqv
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    jcfg = JQwenConfig.tiny()
    vb = jqv.prepare_vision_batch(
        [Image.fromarray(np.zeros((56, 56, 3), np.uint8))],
        head_dim=jcfg.vision.head_dim, min_pixels=56 * 56,
        max_pixels=56 * 56)
    n = vb.reverse_index.shape[0]
    ids = np.full((1, n + 2), 5, np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[0, 1:n + 1] = np.arange(n)
    vision = {k: jnp.asarray(getattr(vb, k)) for k in
              ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
               "reverse_index")}
    jparams = jax.eval_shape(lambda key: JQwen(jcfg).init(
        key, jnp.asarray(ids), vision_batch=vision,
        slot_map=jnp.asarray(slot)), jax.random.PRNGKey(0))
    model = Qwen25VL(Qwen25VLConfig.tiny())
    for n_model in (2, 4):
        jmesh = jbuild_mesh(JMeshConfig(model=n_model, data=-1))
        want = sorted(
            (tuple(x.shape), str(tuple(jtp_spec(
                tuple(getattr(k, "key", str(k)) for k in path), x.shape,
                jmesh))))
            for path, x in jax.tree_util.tree_flatten_with_path(jparams)[0])
        got = sorted(
            (tuple(p.shape), str(M.tp_param_spec(
                tuple(name.split(".")), tuple(p.shape), {"model": n_model})))
            for name, p in model.named_parameters())
        assert got == want
        assert sum("model" in s for _, s in got) > 4


def test_local_batch_size():
    assert M.local_batch_size(8, {"replica": 2, "data": 2}) == 2
    assert M.local_batch_size(8, None) == 8
    with pytest.raises(ValueError):
        M.local_batch_size(6, {"data": 4})


@pytest.fixture(scope="module")
def four_ranks():
    return spawn(mesh_layout, 4, LAYOUTS, np.arange(8))


@pytest.mark.parametrize("at", range(len(LAYOUTS)))
def test_device_mesh_matches_jax_mesh(four_ranks, at):
    """Each rank's coordinates are its device's position in the JAX mesh
    of the same layout over 4 devices, its groups vary only their axes,
    and its local_slice is the shard batch_sharding gives that device."""
    kw = LAYOUTS[at]
    jmesh = jbuild_mesh(JMeshConfig(**kw), devices=jax.devices()[:4])
    devices = list(jmesh.devices.flat)
    arr = jax.device_put(np.arange(8), jbatch_sharding(jmesh, 1))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    grid = np.arange(4).reshape(jmesh.devices.shape)
    names = list(jmesh.axis_names)
    for rank, res in enumerate(four_ranks):
        got = res[at]
        pos = np.argwhere(grid == rank)[0]
        assert got["coords"] == {a: int(pos[i]) for i, a in enumerate(names)}
        np.testing.assert_array_equal(got["slice"], shards[devices[rank]])
        for key, ranks in got["groups"].items():
            axes = key.split("+")
            fixed = [i for i, a in enumerate(names) if a not in axes]
            members = [r for r in range(4) if all(
                np.argwhere(grid == r)[0][i] == pos[i] for i in fixed)]
            assert ranks == members, (key, rank)
