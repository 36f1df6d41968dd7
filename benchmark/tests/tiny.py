"""A LLaMA-family model small enough for the CPU that still takes the
megakernel's path (128-dim heads), and a short mix, for the tests."""

import copy

from benchmark import registry


def config(n_layer: int = 2) -> dict:
    cfg = copy.deepcopy(registry.config("deepseek7b-q4_0"))
    cfg["port"].update(n_embd=256, n_head=2, n_layer=n_layer, n_mult=32, n_ff=704, n_vocab=512, n_ctx=1024)
    return cfg


def mix(name: str = "chat") -> dict:
    m = registry.traffic(name)
    m.update(prompt_tokens=[32, 96], output_tokens=[8, 16], cycle=4, check_tokens=40, check_max_requests=3,
             trace_seconds=0.5)
    return m


#: limits of the tiny model: the port's CPU path reads 0 here
LIMITS = {"mean_gap_excess": 0.01}
