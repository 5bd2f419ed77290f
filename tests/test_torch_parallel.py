"""Sequence parallelism across gloo ranks on the CPU: the port's Ulysses
(parallel/ulysses.py, all_to_all around ops.attention.flash_attention,
whose CPU form is K4's plain version) and ring attention
(parallel/ring.py, P2P) against the port's one-process flash_attention and
the JAX package's ulysses_attention / ring_attention on its CPU mesh
(tests/test_parallel.py's checks).

One job of 2 ranks and one of 4 run every case (tests/torch_dist_workers:
spawned processes that import no jax). Inputs from numpy, fp32, causal;
rows padded at the end (lengths) or packed with segment ids, grouped kv
heads. Tolerances: 2e-5 on outputs and gradients against the port's
one-process attention (the same fp32 arithmetic per head, the softmax
summed in blocks by the ring), 2e-4 on outputs and 2e-3 on gradients
against JAX (tests/test_parallel.py's). Rows past the lengths (padding)
are compared nowhere: their contract differs (the port gives 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from visrag_tpu.config import MeshConfig as JMeshConfig
from visrag_tpu.mesh import SEQ as JSEQ
from visrag_tpu.mesh import build_mesh as jbuild_mesh
from visrag_tpu.parallel.ring import ring_attention as jring
from visrag_tpu.parallel.ulysses import ulysses_attention as julysses
from visrag_tpu_torch.ops.attention import flash_attention
from visrag_tpu_torch.parallel.ulysses import (pad_seq_for_ulysses,
                                               validate_heads)
from torch_dist_workers import sp_attention, spawn

B, S, D = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    (and this file's spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, h, hk, packed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (h, hk, hk))
    seg = np.zeros((B, S), np.int32)
    if packed:
        seg[0, :13], seg[0, 13:27] = 1, 2
        seg[1, :9], seg[1, 9:32] = 3, 4
    else:
        seg[0, :S], seg[1, :21] = 1, 1
    return q, k, v, seg


# (name, world, heads, kv heads, packed, lengths, mesh, backend)
CASES = [
    ("ulysses2_lengths_gqa", 2, 4, 2, False, True, dict(seq=2, data=1),
     "ulysses"),
    ("ulysses2_packed", 2, 4, 4, True, False, dict(seq=2, data=1),
     "ulysses"),
    ("ulysses4_lengths_gqa", 4, 8, 2, False, True, dict(seq=4, data=1),
     "ulysses"),
    ("ulysses2x2_packed", 4, 4, 2, True, False, dict(data=2, seq=2),
     "ulysses"),
    ("ring4_lengths", 4, 2, 2, False, True, dict(seq=4, data=1), "ring"),
    ("ring4_packed_gqa", 4, 4, 2, True, False, dict(seq=4, data=1), "ring"),
]


@pytest.fixture(scope="module")
def runs():
    """{case name: (inputs, [(o, dq, dk, dv) per rank])}, one job per
    world size."""
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c[1] == world]
        inputs = [_inputs(i, h, hk, packed)
                  for i, (_, _, h, hk, packed, *_r) in enumerate(cases)]
        jobs = [(*x, c[5], c[6], c[7]) for x, c in zip(inputs, cases)]
        ranks = spawn(sp_attention, world, jobs)
        for i, c in enumerate(cases):
            out[c[0]] = (inputs[i], c[6], [r[i] for r in ranks])
    return out


def _assemble(mesh_kw, per_rank, part):
    """Each rank's (rows, sequence block) of `part` back into (B, S, ...),
    ranks in (data, seq) order."""
    data, seq = mesh_kw.get("data", 1), mesh_kw.get("seq", 1)
    rows = [np.concatenate([per_rank[d * seq + s][part] for s in range(seq)],
                           axis=1) for d in range(data)]
    return np.concatenate(rows, axis=0)


def _one_process(q, k, v, seg, use_lengths):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = {"lengths": (s > 0).sum(1)} if use_lengths \
        else {"q_seg": s, "kv_seg": s}
    o = flash_attention(*t, causal=True, **kw)
    ((o ** 2) * (s > 0)[:, :, None, None]).sum().backward()
    return [x.detach().numpy() for x in (o, *(a.grad for a in t))]


def _jax(q, k, v, seg, backend, n):
    """JAX's sequence-parallel attention over an n-way seq mesh of the
    8-device CPU mesh, and the gradients of the same masked loss."""
    mesh = jbuild_mesh(JMeshConfig(seq=n, data=1),
                       devices=jax.devices()[:n])
    seg_j = jnp.asarray(seg)
    valid = (seg_j > 0)[:, :, None, None]
    h, hk = q.shape[2], k.shape[2]

    def attend(q, k, v):
        if hk != h:
            k, v = (jnp.repeat(x, h // hk, axis=2) for x in (k, v))
        if backend == "ring":
            return jring(q, k, v, mesh, causal=True, segment_ids=seg_j)
        fn = jax.shard_map(
            lambda q, k, v: julysses(q, k, v, q_seg=seg_j, kv_seg=seg_j,
                                     causal=True),
            mesh=mesh, in_specs=(P(None, JSEQ),) * 3,
            out_specs=P(None, JSEQ), check_vma=False)
        return fn(q, k, v)

    def loss(q, k, v):
        o = attend(q, k, v)
        return jnp.sum(o ** 2 * valid), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, *grads)]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sequence_parallel_attention_matches_full(runs, name):
    (q, k, v, seg), mesh_kw, per_rank = runs[name]
    case = next(c for c in CASES if c[0] == name)
    got = [_assemble(mesh_kw, per_rank, i) for i in range(4)]
    want = _one_process(q, k, v, seg, case[5])
    valid = seg > 0
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=2e-5,
                               atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    jwant = _jax(q, k, v, seg, case[7], mesh_kw["seq"])
    np.testing.assert_allclose(got[0][valid], jwant[0][valid], rtol=2e-4,
                               atol=2e-4)
    for g, w in zip(got[1:], jwant[1:]):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_pad_and_validate():
    x = torch.ones((1, 10, 4, 8))
    padded, orig = pad_seq_for_ulysses(x, 4)
    assert padded.shape == (1, 12, 4, 8) and orig == 10
    assert torch.equal(padded[:, :10], x) and not padded[:, 10:].any()
    same, n = pad_seq_for_ulysses(x, 5)
    assert same is x and n == 10
    validate_heads(8, 4)
    with pytest.raises(ValueError):
        validate_heads(6, 4)
