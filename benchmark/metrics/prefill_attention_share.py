"""Prefill attention's share of prefill's device time: over the traced
requests, the device time of the kernels launched in the program's
``prefill.attention`` spans (``models/llama.py``: ``_attention`` or
``_attention_chunked`` of each layer) over that of those launched in
``prefill`` and the spans inside it (``benchmark/program_spans.py``)."""

UNIT = "%"


def read(run):
    from benchmark import program_spans

    us = program_spans.device_us(run, ("prefill", "prefill.attention"))
    return 100.0 * us["prefill.attention"] / us["prefill"] if us["prefill"] else None
