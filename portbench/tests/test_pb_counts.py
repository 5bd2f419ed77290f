"""The yardstick's counts against shapes worked out by hand."""

import pytest

from portbench import counts


def test_k1_vit_flat_116_slices_of_1088_d72():
    # pairs 116 * 1088^2 = 137,314,304; QK^T and PV: 4 * pairs * 16 * 72
    # q, k, v read and o written: 2 B * 126,208 rows * 72 * (16 * 4)
    flops, nbytes = counts.k1_counts([1088] * 116, 16, 72, causal=False)
    assert flops == 632_744_312_832
    assert nbytes == 1_163_132_928
    assert counts.bound_s(flops, nbytes) == pytest.approx(
        632_744_312_832 / 989e12)                  # operations bound it


def test_k1_causal_gqa_counts_kv_heads_once():
    # one row of 4096, causal: 4096 * 4097 / 2 pairs; 28 q / 4 kv heads
    flops, nbytes = counts.k1_counts([4096], 28, 128, True, kv_heads=4)
    assert flops == 4 * (4096 * 4097 // 2) * 28 * 128
    assert nbytes == 2 * 4096 * 128 * (2 * 28 + 2 * 4)


def test_k5_at_the_7b_decode_lengths():
    # 4 slots at 4815 / 4643 / 4879 / 650 live tokens (sum 14,987), 28 q
    # and 4 kv heads of 128: K and V of each token read once (bf16), q and
    # o of each slot
    flops, nbytes = counts.k5_counts([4815, 4643, 4879, 650], 28, 4, 128)
    assert flops == 214_853_632
    assert nbytes == 30_693_376 + 57_344
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(
        0.0091793, rel=1e-4)                       # bytes bound it


def test_scan_1m_by_2304_for_64_queries():
    flops, nbytes = counts.scan_counts(1_000_000, 2304, 64, 10)
    assert flops == 294_912_000_000
    assert nbytes == 9_216_594_944
    # fp32 outside the tensor cores: operations bound it (4.40 ms)
    assert counts.bound_s(flops, nbytes, counts.PEAK_FP32_FLOPS) == \
        pytest.approx(294_912_000_000 / 67e12)


def test_decoder_flops_prefill_equals_decode_steps_summed():
    # a 5-token prompt then 3 decode steps = an 8-token causal pass
    t = dict(hidden=64, inter=128, layers=2, heads=4, kv_heads=2,
             head_dim=16)
    whole = counts.decoder_flops(lengths=[8], **t)
    parts = counts.decoder_flops(lengths=[5], **t) + counts.decoder_flops(
        lengths=[1, 1, 1], past=[5, 6, 7], **t)
    assert whole == parts


def test_minicpm_flops_of_one_token():
    llm = {"hidden_size": 2304, "intermediate_size": 5760,
           "num_hidden_layers": 40, "num_attention_heads": 36,
           "num_key_value_heads": 36}
    dense = 40 * (4 * 2304 * 2304 + 3 * 2304 * 5760)
    assert counts.minicpm_flops(llm, [1]) == 2 * dense + 4 * 1 * 2304 * 40
