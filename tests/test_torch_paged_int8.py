"""visrag_tpu_torch's int8 KV pools (Engine(cache_dtype="int8"), K5's int8
variant) against visrag_tpu's.

The port's pools are layer-stacked KVQuant leaves (int8 data, fp32 scales
per (token, kv head) in (n_blocks, kvh, bs)); the JAX package's are one
KVQuant per layer with row-form scales (n_blocks, 1, kvh*bs). The tests
move pools between the two layouts with numpy. Tolerances:

  * codes, scales and written pools: equal bit for bit (the same fp32
    divide, round half to even and clip);
  * the plain quantized decode (the TPU kernel's arithmetic) against the
    Pallas kernel in interpret mode on the same pools: rtol 2e-2, atol
    8e-3, the bar tests/test_paged_int8.py holds that kernel to against a
    dequantized reference; against the JAX package's XLA path (fp32
    dequantized values, no bf16 rounding): the same bar;
  * engines: token-identical greedy outputs and identical scheduling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import _run, _scenario, _stats, models  # noqa: F401
from visrag_tpu.serving import paged_kv as jpk
from visrag_tpu.serving.engine import Engine as JEngine
from visrag_tpu.serving.sampling import SamplingParams as JSampling
from visrag_tpu_torch.serving import paged_kv as pk
from visrag_tpu_torch.serving.engine import Engine
from visrag_tpu_torch.serving.sampling import SamplingParams

KERNEL_TOL = dict(rtol=2e-2, atol=8e-3)


def _to_jax(pool):
    """One layer's port KVQuant → the JAX package's KVQuant (row form)."""
    nb, kvh, bs, _ = pool.data.shape
    return jpk.KVQuant(jnp.asarray(pool.data.numpy()),
                       jnp.asarray(pool.scale.numpy().reshape(nb, 1,
                                                              kvh * bs)))


def test_quantize_kv_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 2, 64)) * 3).astype(np.float32)
    x[3, 1] = 0.0                         # a zero row: scale 1, codes 0
    q, sc = pk.quantize_kv(torch.from_numpy(x))
    jq, jsc = jpk.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.shape == (7, 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert sc[3, 1].item() == 1.0 and not q[3, 1].any()
    assert pk.quant_pool_shapes(5, 128, 2, 64) == ((5, 2, 128, 64),
                                                   (5, 2, 128))


def test_pool_writes_match_jax():
    """write_prefill (layer-stacked), write_token and pool_gather on
    KVQuant pools equal the JAX package's per-layer writes."""
    rng = np.random.default_rng(1)
    layers, kvh, d, bs, nb = 2, 2, 64, 16, 9
    dsh, ssh = pk.quant_pool_shapes(nb, bs, kvh, d)
    pool = pk.KVQuant(torch.zeros((layers,) + dsh, dtype=torch.int8),
                      torch.zeros((layers,) + ssh))
    vpool = pk.KVQuant(pool.data.clone(), pool.scale.clone())
    jdsh, jssh = jpk.quant_pool_shapes(nb, bs, kvh, d)
    jpool = tuple(jpk.KVQuant(jnp.zeros(jdsh, jnp.int8),
                              jnp.zeros(jssh, jnp.float32))
                  for _ in range(layers))
    bucket = 2 * bs
    k = rng.standard_normal((layers, 1, bucket, kvh, d)).astype(np.float32)
    rows = np.array([4, 1], np.int32)
    pk.write_prefill(pool, vpool, torch.from_numpy(k), torch.from_numpy(k),
                     rows, bucket)
    jpool, _ = jpk.write_prefill(jpool, jpool, jnp.asarray(k),
                                 jnp.asarray(k), jnp.asarray(rows), bucket)
    table = np.array([[4, 1, 7], [2, 3, 5]], np.int32)
    pos = np.array([bs + 3, 2 * bs + 5], np.int32)
    x = rng.standard_normal((2, kvh, d)).astype(np.float32)
    for layer in range(layers):
        pk.write_token(pool[layer], torch.from_numpy(table),
                       torch.from_numpy(pos), torch.from_numpy(x))
    jpool = tuple(jpk.write_token(p, jnp.asarray(table), jnp.asarray(pos),
                                  jnp.asarray(x)) for p in jpool)
    for layer in range(layers):
        want = jpool[layer]
        np.testing.assert_array_equal(pool.data[layer].numpy(),
                                      np.asarray(want.data))
        np.testing.assert_array_equal(
            pool.scale[layer].numpy().reshape(nb, 1, kvh * bs),
            np.asarray(want.scale))
        got = pk.pool_gather(pool[layer], torch.tensor([4, 1, 5]),
                             torch.float32)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpk.pool_gather(
                want, jnp.asarray([4, 1, 5]), jnp.float32)))
    # a block copy carries the scales with the data (the fork's partial
    # block)
    pool[:, 8] = pool[:, 4]
    assert torch.equal(pool.scale[:, 8], pool.scale[:, 4])
    assert torch.equal(pool.data[:, 8], pool.data[:, 4])


def _decode_case(seed, h=8, kvh=2, d=64, bs=128, mb=4,
                 lengths=(5, 300, 512)):
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    nb = slots * mb + 1
    q = rng.standard_normal((slots, h, d)).astype(np.float32)
    dsh, ssh = pk.quant_pool_shapes(nb, bs, kvh, d)
    pools = []
    for _ in range(2):
        pool = pk.KVQuant(torch.zeros(dsh, dtype=torch.int8),
                          torch.zeros(ssh))
        pk.pool_write_rows(pool, torch.arange(nb), torch.from_numpy(
            rng.standard_normal((nb, kvh, bs, d)).astype(np.float32)))
        pools.append(pool)
    table = rng.permutation(nb - 1)[:slots * mb].reshape(slots, mb)
    return (q, pools, table.astype(np.int32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("case", ["mixed", "edges", "minicpm_bs8"])
def test_quantized_decode_matches_pallas_interpret(case):
    """The plain int8 decode (the port's CPU path) against the JAX Pallas
    kernel's quantized branch in interpret mode and against its XLA path,
    on the same pools; lengths straddling block edges and a length of 1;
    and MiniCPM-2B's grouping (one query head a kv head, d 64; 6/6 here) on
    8-token blocks, lengths 1, 8, 9 and 300."""
    if case == "minicpm_bs8":
        q, (kp, vp), table, lens = _decode_case(
            3, h=6, kvh=6, d=64, bs=8, mb=40, lengths=(1, 8, 9, 300))
    else:
        lengths = (5, 300, 512) if case == "mixed" else (1, 128, 129, 257)
        q, (kp, vp), table, lens = _decode_case(2, lengths=lengths)
    before = (pk.launches, pk.int8_launches)
    got = pk.paged_decode_attention(torch.from_numpy(q), kp, vp,
                                    torch.from_numpy(table),
                                    torch.from_numpy(lens)).numpy()
    assert (pk.launches, pk.int8_launches) == before   # CPU: no launch
    args = (jnp.asarray(q), _to_jax(kp), _to_jax(vp), jnp.asarray(table),
            jnp.asarray(lens))
    kern = np.asarray(jpk.paged_decode_attention(*args, interpret=True))
    xla = np.asarray(jpk.paged_decode_attention(*args))
    np.testing.assert_allclose(got, kern, **KERNEL_TOL)
    np.testing.assert_allclose(got, xla, **KERNEL_TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("case", ["n_sample_groups", "chunked_text",
                                  "prefix_cache"])
def test_int8_engine_matches_jax_int8_engine(models, case):  # noqa: F811
    """Greedy outputs of the port's int8 engine equal the JAX int8
    engine's, with forks of an n-sample group (their partial block copied
    with its scales), chunked prefill (pool_write_rows / pool_gather inside
    prefill_chunk) and the prefix cache; then sleep and wake rebuild the
    int8 pools and serve the same outputs."""
    jm, params, port = models
    kw, prompts, skw, n = _scenario(case)
    je = JEngine(jm, params, cache_dtype="int8", **kw)
    want = _run(je, prompts, JSampling(temperature=0.0,
                                       repetition_penalty=1.05, **skw), n)
    pe = Engine(port, cache_dtype="int8", **kw)
    assert pe.kv_quant and isinstance(pe.k_cache, pk.KVQuant)
    sp = SamplingParams(temperature=0.0, repetition_penalty=1.05, **skw)
    got = _run(pe, prompts, sp, n)
    assert got == want
    assert _stats(pe) == _stats(je)
    pe.sleep()
    assert pe.k_cache is None
    pe.wake()
    assert isinstance(pe.k_cache, pk.KVQuant)
    assert pe.k_cache.data.dtype == torch.int8


def test_engine_refuses_other_cache_dtypes(models):  # noqa: F811
    with pytest.raises(ValueError):
        Engine(models[2], num_slots=2, max_len=64, prompt_buckets=(16,),
               cache_dtype="float16")


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,d,bs,lens", [
    (36, 36, 64, 8, [1, 8, 9, 4096]),        # MiniCPM-2B, bs 8
    (16, 2, 128, 8, [1, 8, 9, 16536, 15064, 700, 64, 65]),   # 3B rollout
    (28, 4, 128, 8, [4815, 4643, 4879, 650]),                # 7B, bs 8
])
def test_int8_kernel_new_shapes_on_card(h, kvh, d, bs, lens):
    """K5's int8 variant at the head dims, groupings and block sizes of
    the port's paths, lengths 1, bs and bs + 1 among them: 0.0035 relative
    Frobenius error against its plain version, finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    nb = sum(-(-n // bs) for n in lens) + 1
    pools = []
    for _ in range(2):
        pool = pk.KVQuant(torch.zeros((nb, kvh, bs, d), dtype=torch.int8,
                                      device="cuda"),
                          torch.zeros((nb, kvh, bs), device="cuda"))
        pk.pool_write_rows(pool, torch.arange(nb, device="cuda"),
                           torch.randn(nb, kvh, bs, d, generator=g,
                                       device="cuda"))
        pools.append(pool)
    mb = max(-(-n // bs) for n in lens)
    table = torch.full((len(lens), mb), nb - 1, dtype=torch.int32,
                       device="cuda")
    perm = torch.randperm(nb - 1, generator=g, device="cuda").int()
    at = 0
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = perm[at:at + used]
        at += used
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), h, d, generator=g, device="cuda").bfloat16()
    out = pk.paged_decode_attention(q, *pools, table, lengths)
    ref = pk.paged_decode_reference(q, *pools, table, lengths, d ** -0.5)
    assert torch.isfinite(out.float()).all()
    rel = (torch.linalg.norm((out - ref).float())
           / torch.linalg.norm(ref.float())).item()
    assert rel <= 3.5e-3, rel


@pytest.mark.gpu
def test_int8_kernel_matches_plain_on_card():
    """K5's int8 variant against its plain version at the 7B grouping
    (28/4, d 128, bs 128), 0.0035 relative Frobenius error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    slots, h, kvh, d, bs, nb = 4, 28, 4, 128, 128, 64
    pools = []
    for _ in range(2):
        pool = pk.KVQuant(torch.zeros((nb, kvh, bs, d), dtype=torch.int8,
                                      device="cuda"),
                          torch.zeros((nb, kvh, bs), device="cuda"))
        pk.pool_write_rows(pool, torch.arange(nb, device="cuda"),
                           torch.randn(nb, kvh, bs, d, generator=g,
                                       device="cuda"))
        pools.append(pool)
    table = torch.randperm(nb - 1, generator=g, device="cuda")[
        :slots * 15].reshape(slots, 15).int().contiguous()
    lens = torch.tensor([1, 128, 129, 1900], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(slots, h, d, generator=g, device="cuda").bfloat16()
    out = pk.paged_decode_attention(q, *pools, table, lens)
    ref = pk.paged_decode_reference(q, *pools, table, lens, d ** -0.5)
    rel = (torch.linalg.norm((out - ref).float())
           / torch.linalg.norm(ref.float())).item()
    assert rel <= 3.5e-3, rel
