from . import ggml, quant  # noqa: F401
