"""The frozen generators: a seed reproduces its bytes, and the sizes and
the skew are as the configurations state."""

import collections

import numpy as np
import pytest
import torch

from mrbench.gen import graph500, html

ABCD = (0.57, 0.19, 0.19, 0.05)
SEED = 2 ** 31 + 977


def test_graph_seed_reproduces_its_edges():
    a = graph500.generate(SEED, 10, 16, ABCD, chunk_log2=12)
    b = graph500.generate(SEED, 10, 16, ABCD, chunk_log2=10)
    c = graph500.generate(SEED + 1, 10, 16, ABCD)
    assert torch.equal(a["edges"], b["edges"])
    assert not torch.equal(a["edges"][:100], c["edges"][:100])
    assert a["draws"] == 16 << 10


def test_graph_draws_depend_on_the_index_alone():
    whole = graph500.kronecker_edges(SEED, 12, 0, 4096, ABCD)
    part = graph500.kronecker_edges(SEED, 12, 1000, 500, ABCD)
    assert torch.equal(whole[0][1000:1500], part[0])
    assert torch.equal(whole[1][1000:1500], part[1])


def test_graph_initiator_and_skew():
    scale, n = 16, 1 << 18
    src, dst = graph500.kronecker_edges(SEED, scale, 0, n, ABCD)
    # the top bit of the row is 1 with probability C + D = 0.24, of the
    # column with B + D = 0.24
    top = 1 << (scale - 1)
    assert abs(float(((src & top) > 0).float().mean()) - 0.24) < 0.005
    assert abs(float(((dst & top) > 0).float().mean()) - 0.24) < 0.005
    deg = torch.bincount(src, minlength=1 << scale)
    assert int(deg.max()) > 50 * n / (1 << scale)      # heavy head
    assert int((deg == 0).sum()) > (1 << scale) // 4    # and empty rows


def test_graph_labels_are_a_permutation_and_repeats_culled():
    perm = graph500.label_permutation(SEED, 10)
    assert torch.equal(torch.sort(perm).values, torch.arange(1024))
    src = torch.tensor([3, 1, 3, 2, 1])
    dst = torch.tensor([4, 2, 4, 2, 2])
    got = graph500.unique_edges(src, dst, 3)
    assert got.tolist() == [[3, 4], [1, 2], [2, 2]]
    g = graph500.generate(SEED, 10, 16, ABCD)
    packed = g["edges"][:, 0] * 1024 + g["edges"][:, 1]
    assert packed.unique().numel() == g["unique"] < g["draws"]


def test_graph_hash_has_no_overflowing_product():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 12345], dtype=torch.int64)
    got = graph500._mul32(x, 0x85EBCA6B).tolist()
    assert got == [(v * 0x85EBCA6B) & 0xFFFFFFFF for v in x.tolist()]


def _corpus(tmp_path, seed, sub):
    d = tmp_path / sub
    d.mkdir()
    return html.make_corpus(str(d), seed, 1 << 21, 4, 1 << 12, 2.1, 50)


def test_corpus_seed_reproduces_its_bytes(tmp_path):
    (p1, i1), (p2, _), (p3, i3) = (_corpus(tmp_path, SEED, "a"),
                                   _corpus(tmp_path, SEED, "b"),
                                   _corpus(tmp_path, SEED + 1, "c"))
    for a, b in zip(p1, p2):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert open(p1[0], "rb").read() != open(p3[0], "rb").read()
    # every seed writes the same number of references
    assert i1["refs"] == i3["refs"] == 4 * html.pages_per_file(1 << 21, 4)
    assert abs(i1["bytes"] - (1 << 21)) < 0.06 * (1 << 21)


def test_corpus_urls_lengths_and_long_share(tmp_path):
    paths, info = _corpus(tmp_path, SEED, "a")
    urls = [u for f in html.file_urls(paths) for u in f]
    assert len(urls) == info["refs"]
    assert all(b"<" not in u and b'"' not in u for u in urls)
    long = [u for u in urls if len(u) >= 64]
    assert all(120 <= len(u) <= 199 for u in long)
    assert all(26 <= len(u) <= 47 for u in urls if len(u) < 64)
    assert 0.005 < len(long) / len(urls) < 0.06


def test_corpus_popularity_follows_the_power_law():
    n, vocab = 1 << 18, 1 << 20
    ranks = html.draw_ranks(SEED, n, vocab, 2.1)
    freq = collections.Counter(ranks.tolist())
    cdf = html.rank_cdf(vocab, 2.1)
    # the top rank's share and the rank-frequency slope, -1 / 1.1
    assert abs(freq[0] / n - cdf[0]) < 0.1 * cdf[0]
    r = np.array([1, 2, 4, 8, 16, 32])
    f = np.array([freq[k - 1] for k in r], np.float64)
    slope = np.polyfit(np.log(r), np.log(f), 1)[0]
    assert -1.05 < slope < -0.75


@pytest.mark.cuda
def test_graph_on_the_card_equals_the_cpu(card):
    a = graph500.generate(SEED, 14, 16, ABCD, device=card)
    b = graph500.generate(SEED, 14, 16, ABCD)
    assert torch.equal(a["edges"].cpu(), b["edges"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_graph_shuffle_keeps_the_edges_in_another_order():
    packed, _ = graph500.generate_packed(SEED, 10, 16, ABCD)
    a, b = graph500.shuffle(packed, 1), graph500.shuffle(packed, 2)
    assert torch.equal(torch.sort(a).values, torch.sort(packed).values)
    assert torch.equal(torch.sort(b).values, torch.sort(packed).values)
    assert not torch.equal(a, b)
    assert torch.equal(a, graph500.shuffle(packed, 1))


def test_corpus_order_seed_keeps_each_file_in_another_order(tmp_path):
    def files(sub, order):
        d = tmp_path / sub
        d.mkdir()
        paths, info = html.make_corpus(str(d), SEED, 1 << 20, 4, 1 << 10,
                                       2.1, 50, order_seed=order)
        return [open(p, "rb").read() for p in paths], info
    (a, ia), (b, ib) = files("a", 1), files("b", 2)
    assert ia == ib and [len(x) for x in a] == [len(x) for x in b]
    assert a != b
    for x, y in zip(a, b):
        assert sorted(html.href_urls(x)) == sorted(html.href_urls(y))
