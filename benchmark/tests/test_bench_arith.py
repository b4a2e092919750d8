"""Operations, bytes and tails against hand sums."""

import pytest

from benchmark import arith, core


def _shape(name):
    return arith.Shape.from_config(core.load_config(name))


def test_parameter_counts_match_the_published_models():
    # Mistral-7B-v0.1 has 7,241,732,096 parameters and Qwen2-7B
    # 7,615,616,512; less the embedding and the output head.
    m, q = _shape("mistral-7b"), _shape("qwen2-7b")
    assert m.nonembed_params + 2 * 32000 * 4096 == 7_241_732_096
    assert q.nonembed_params + 2 * 152064 * 3584 == 7_615_616_512
    assert m.window == 4096 and q.window is None and q.qkv_bias


@pytest.mark.parametrize("t,w", [(1, None), (7, None), (7, 3), (10, 10),
                                 (10, 1), (33, 8)])
def test_kept_pairs_count_the_mask(t, w):
    brute = sum(1 for i in range(t) for j in range(t)
                if j <= i and (w is None or i - j < w))
    assert arith.kept_pairs(t, w) == brute


def test_k6_launch_by_hand():
    s = _shape("mistral-7b")
    # Two slots at contexts 10 and 5000 (capped at the 4096 window), FP8.
    f, b = arith.k6_launch(s, [10, 5000], 1, True)
    assert f == 4 * 128 * 32 * (10 + 4096)
    row = 8 * 128 * 1 + 8 * 4           # values and fp32 scales
    assert b == 2 * (10 + 4096) * row + 2 * (2 * 32 * 128 * 2)
    f2, b2 = arith.k6_launch(s, [10], 2, False)
    assert b2 == 2 * 10 * 8 * 128 * 2 + 2 * 32 * 128 * 2


def test_k1_and_prefill_by_hand():
    s = _shape("qwen2-7b")
    f, b = arith.k1_launch(s, 100)
    assert f == 4 * 128 * 28 * (100 * 101 // 2)
    assert b == 2 * 100 * 128 * (2 * 28 + 2 * 4)
    assert arith.prefill_flops(s, 100) == (
        2 * s.nonembed_params * 100 + 28 * f + 2 * 3584 * 152064)
    assert arith.decode_flops(s, 3) == (
        2 * s.nonembed_params + 4 * 128 * 28 * 3 * 28 + 2 * 3584 * 152064)


def test_least_seconds_takes_the_larger_bound():
    assert arith.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert arith.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert arith.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


def test_tail_is_the_nearest_rank():
    v = list(range(1, 101))
    assert arith.tail(v) == 95
    assert arith.tail([5.0]) == 5.0
    assert arith.tail(list(range(1, 21))) == 19
    assert arith.tail([3, 1, 2]) == 3


def test_kernel_groups_first_match_wins():
    assert arith.group_of("void mfa_gemm_sm90<...>") == "gemm_kernel"
    assert arith.group_of("decode_attend_mma<PagedRows<fp8>>") == \
        "paged_decode"
    assert arith.group_of("flash_fwd_wgmma") == "flash_fwd"
    assert arith.group_of("nvjet_tst_128x64") == "matmul"
    assert arith.group_of("elementwise_kernel") == "other"
