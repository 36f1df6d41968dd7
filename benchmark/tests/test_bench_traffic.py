import itertools

import pytest

from benchmark import registry, traffic


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_deterministic_per_seed(name):
    mix = registry.traffic(name)
    a = list(itertools.islice(traffic.requests(mix, 2**31 + 12345, 102400), 40))
    b = list(itertools.islice(traffic.requests(mix, 2**31 + 12345, 102400), 40))
    c = list(itertools.islice(traffic.requests(mix, 7, 102400), 40))
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_ranges_and_ids(name):
    mix = registry.traffic(name)
    for r in itertools.islice(traffic.requests(mix, 99, 102400), 3 * mix["cycle"]):
        lo, hi = mix["prompt_tokens"]
        assert lo <= r.prompt_len <= hi
        lo, hi = mix["output_tokens"]
        assert lo <= r.n_predict <= hi
        assert r.prompt[0] == traffic.BOS and min(r.prompt[1:]) >= traffic.FIRST_ID and max(r.prompt) < 102400
        assert r.greedy == (r.index % mix["greedy_every"] == 0)


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_every_seed_draws_the_same_sizes(name):
    mix = registry.traffic(name)
    n = mix["cycle"]

    def sizes(seed):
        reqs = list(itertools.islice(traffic.requests(mix, seed, 1000), n))
        return sorted(r.prompt_len for r in reqs), sorted(r.n_predict for r in reqs), [r.n_predict for r in reqs]

    a, b = sizes(1), sizes(2**33 + 1)
    assert a[0] == b[0] and a[1] == b[1]
    assert a[2] != b[2]  # in another order


def test_warmup_covers_every_bucket():
    mix = registry.traffic("rag")
    reqs = traffic.warmup_requests(mix, 64, 5, 1000)
    assert [-(-r.prompt_len // 64) * 64 for r in reqs] == traffic.buckets(mix, 64)
    sent = {-(-r.prompt_len // 64) * 64 for r in itertools.islice(traffic.requests(mix, 3, 1000), 200)}
    assert sent <= set(traffic.buckets(mix, 64))


def test_grid():
    assert traffic.grid(16, 48, 4) == [20, 28, 36, 44]


@pytest.mark.parametrize("n_vocab", [102400, 103168])
def test_prompt_pieces_tokenize_back_to_their_ids(n_vocab):
    from llama_swift_torch.tokenizer import Vocab

    from benchmark.systems import llama as system

    pieces = system.vocab_pieces(n_vocab)
    assert len(pieces) == n_vocab and len(set(pieces)) == n_vocab
    vocab = Vocab(pieces)
    for r in itertools.islice(traffic.requests(registry.traffic("chat"), 11, n_vocab), 4):
        text = b"".join(pieces[t] for t in r.prompt[1:]).decode()
        assert vocab.tokenize(text, bos=True) == list(r.prompt)
    assert vocab.tokenize(pieces[2].decode() + pieces[n_vocab - 1].decode()) == [2, n_vocab - 1]
