"""The sampler's share of the decode step's device time: over the traced
requests, the device time of the kernels launched in the program's
``decode.sample`` spans (``runtime/device_sampler.py``: the draw and the
ring write) over that of those launched in ``decode.step`` (the model's
forward) and ``decode.sample`` (``benchmark/program_spans.py``)."""

UNIT = "%"


def read(run):
    from benchmark import program_spans

    us = program_spans.device_us(run, ("decode.step", "decode.sample"))
    total = us["decode.step"] + us["decode.sample"]
    return 100.0 * us["decode.sample"] / total if total else None
