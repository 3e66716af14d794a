"""The traffic generator: determinism, the same sizes for every seed, the
cold share the mixes are built for, and the length distribution."""
import numpy as np

from bench_port import loadgen
from bench_port.conftest import HERE

LONGTAIL = loadgen.load(HERE / "traffic" / "longtail.json")
HOT = loadgen.load(HERE / "traffic" / "hot.json")


def test_same_seed_same_sequence_and_prompts():
    a, b = loadgen.Sequence(LONGTAIL, 4, 2**31 + 17), loadgen.Sequence(LONGTAIL, 4, 2**31 + 17)
    assert [a[i] for i in range(300)] == [b[i] for i in range(300)]
    assert all((a.tokens(i, 65024) == b.tokens(i, 65024)).all() for i in (0, 7, 299))
    c = loadgen.Sequence(LONGTAIL, 4, 2**31 + 18)
    assert [a[i] for i in range(64)] != [c[i] for i in range(64)]


def test_every_seed_serves_the_same_sizes_balanced():
    want = sorted(loadgen.strata_lengths(LONGTAIL["lengths"]))
    totals = []
    for seed in (0, 1, -5, 2**33 + 1):
        s = loadgen.Sequence(LONGTAIL, 4, seed)
        for b in range(3):
            assert sorted(s[i][1] for i in range(64 * b, 64 * b + 64)) == want
        totals.append(sum(s[i][1] for i in range(200)))
    assert max(totals) / min(totals) < 1.03      # a partial block serves ~the same work
    a, b = loadgen.Sequence(LONGTAIL, 4, 5), loadgen.Sequence(LONGTAIL, 4, 2**31 + 9)
    assert [a[i][1] for i in range(200)] == [b[i][1] for i in range(200)]
    assert [a[i][0] for i in range(200)] != [b[i][0] for i in range(200)]
    groups = loadgen.length_groups(want)
    for r in range(64 // loadgen.GROUPS):              # each round takes one of each group
        got = {groups[a[i][1]] for i in range(loadgen.GROUPS * r, loadgen.GROUPS * (r + 1))}
        assert got == set(range(loadgen.GROUPS))
    tokens = loadgen.Sequence(LONGTAIL, 4, 3).tokens(5, 100)
    assert tokens.min() >= 0 and tokens.max() < 100


def test_length_quantiles_match_the_mix():
    lengths = loadgen.strata_lengths(LONGTAIL["lengths"])
    assert HOT["lengths"] == LONGTAIL["lengths"]
    assert min(lengths) >= 128 and max(lengths) == 4096
    assert abs(np.median(lengths) - 1020) <= 16              # the source's median
    # the lognormal's p90 (2,842) and its mean clipped at 4,096 (~1,330)
    assert abs(np.quantile(lengths, 0.9) - 2842) / 2842 < 0.05
    assert abs(np.mean(lengths) - 1330) < 10
    assert all(x % 16 == 0 for x in lengths)
    groups = loadgen.length_groups(lengths)
    assert sorted(set(groups.values())) == list(range(loadgen.GROUPS))
    assert groups[min(lengths)] == 0 and groups[max(lengths)] == loadgen.GROUPS - 1


def _cold_share(mix, cap, seed, n):
    """The share of ``n`` invocations that meet no live instance under an
    LRU cap of ``cap`` live instances, starting empty."""
    seq, live, cold = loadgen.Sequence(mix, cap, seed), [], 0
    for i in range(n):
        fn, _ = seq[i]
        if fn in live:
            live.remove(fn)
        else:
            cold += 1
            live = live[-(cap - 1):] if cap > 1 else []
        live.append(fn)
    return cold / n


def test_cold_shares_of_the_mixes():
    for cap, want in ((4, 0.985), (8, 0.97)):
        assert abs(_cold_share(LONGTAIL, cap, 11, 5000) - want) < 0.01
    hot = loadgen.Sequence(HOT, 8, 11)
    assert hot.n_functions == 8
    picks = np.bincount([hot[i][0] for i in range(6400)], minlength=8)
    assert picks.min() > 0.8 * 800 and picks.max() < 1.2 * 800   # uniform over the cap

