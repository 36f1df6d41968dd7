import copy

import pytest

from benchmark import registry

counts = registry.counts("llama")

#: InternLM-20B's widths (huggingface.co/internlm/internlm-20b config.json),
#: a configuration that no cell runs yet
INTERNLM_20B = dict(n_embd=5120, n_head=40, n_layer=60, n_ff=13824, n_vocab=103168)


def _config(**port) -> dict:
    cfg = copy.deepcopy(registry.config("deepseek7b-q4_0"))
    cfg["port"].update(port)
    return cfg


def test_7b_token_bytes_by_hand():
    d = counts.dims(registry.config("deepseek7b-q4_0"))
    # per layer 3·4096² + 4096² + 2·11008·4096 + 4096·11008 weights, 20 bytes a 32
    per_layer = (4 * 4096 * 4096 + 3 * 11008 * 4096) * 20 / 32
    assert counts.layer_weight_bytes(d) == pytest.approx(30 * per_layer)
    assert counts.layer_weight_bytes(d) / 1e9 == pytest.approx(3.80, abs=0.01)
    assert counts.output_weight_bytes(d) / 1e9 == pytest.approx(0.262, abs=0.001)
    assert counts.token_weight_bytes(d) / 1e9 == pytest.approx(4.06, abs=0.01)
    # K/V: 2 planes × 30 layers × 4096 f32 a position
    assert counts.megakernel_bytes(d, 100) - counts.megakernel_bytes(d, 99) == 2 * 30 * 4096 * 4


def test_20b_token_bytes_by_hand():
    d = counts.dims(_config(**INTERNLM_20B))
    assert counts.layer_weight_bytes(d) / 1e9 == pytest.approx(11.90, abs=0.01)
    assert counts.token_weight_bytes(d) / 1e9 == pytest.approx(12.2, abs=0.05)
    # 12.2 GB of weights and 1.23 GB of K/V (502 rows of K and V in 60
    # layers of 5120 f32) at n_past 500, over 3.35 TB/s: 4.0 ms
    kv = 2 * 60 * 5120 * 4 * 502
    assert counts.decode_step_bound_s(d, 500) == pytest.approx(
        counts.decode_step_bytes(d, 500) / 3.35e12)
    assert counts.decode_step_bytes(d, 500) == pytest.approx(counts.token_weight_bytes(d) + kv, rel=1e-3)
    assert 3.95e-3 < counts.decode_step_bound_s(d, 500) < 4.05e-3


def test_prefill_flops_by_hand():
    d = counts.dims(registry.config("deepseek7b-q4_0"))
    params = 4 * 4096 * 4096 + 3 * 11008 * 4096
    n = 3
    attn = 4 * 4096 * (1 + 2 + 3)  # 30 layers of causal keys 1, 2, 3
    assert counts.prefill_flops(d, n) == 2 * n * 30 * params + 30 * attn + 2 * 102400 * 4096


def test_dequant_order_and_bound():
    d = counts.dims(registry.config("deepseek7b-q4_0"))
    shapes = counts.prefill_dequant_shapes(d)
    assert len(shapes) == 4 * 30 + 1 and shapes[:4] == [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008)]
    assert shapes[-1] == (102400, 4096)
    assert counts.dequant_bound_s(4096, 4096) == pytest.approx(4096 * 4096 * (0.625 + 2) / 3.35e12)
