"""The closed loop's traffic: the same seed gives the same requests, and
every seed the same sizes."""

from benchmark import traffic
from benchmark.tests import tiny


def _requests(seed, rounds=3):
    plan = traffic.ClosedLoop(tiny.CELL, seed, 256)
    return [plan.request(c, r) for r in range(rounds)
            for c in range(plan.clients)]


def test_a_seed_repeats_its_requests():
    assert _requests(2**40 + 3) == _requests(2**40 + 3)


def test_seeds_deal_the_same_sizes_in_another_order():
    a, b = _requests(11), _requests(2**31 + 5)
    for r in (1, 2):
        for part in (lambda q: len(q[0]), lambda q: q[1]):
            assert sorted(map(part, a[4 * r:4 * r + 4])) == sorted(
                map(part, b[4 * r:4 * r + 4]))
    assert [p for p, _ in a] != [p for p, _ in b]


def test_sizes_are_the_strata_midpoints():
    assert traffic.strata(512, 4096, 2) == [861, 2435]
    assert traffic.strata(16, 16, 3) == [16, 16, 16]
    plan = traffic.ClosedLoop(dict(tiny.CELL, clients=128,
                                   prompt_tokens=[512, 4096]), 1, 100)
    assert min(plan.prompt_sizes) > 512 and max(plan.prompt_sizes) < 4096
    assert plan.buckets_used([512, 1024, 2048, 4096]) == [1024, 2048, 4096]


def test_round_zero_is_cut_to_a_residual():
    plan = traffic.ClosedLoop(tiny.CELL, 5, 256)
    first = sorted(plan.request(c, 0)[1] for c in range(plan.clients))
    later = sorted(plan.request(c, 1)[1] for c in range(plan.clients))
    assert all(f >= 2 for f in first) and sum(first) < sum(later)


def test_prompt_tokens_cover_the_vocabulary():
    plan = traffic.ClosedLoop(dict(tiny.CELL, prompt_tokens=[4000, 4000]),
                              9, 256)
    prompt, _ = plan.request(0, 1)
    assert min(prompt) >= 0 and max(prompt) <= 255
    assert len(set(prompt)) > 250
