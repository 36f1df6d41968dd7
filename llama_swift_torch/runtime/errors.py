"""Typed error taxonomy, parity with ``LlamaError``
(``Sources/llamaObjCxx/headers/LlamaError.h:12-19``,
``bridge/LlamaError.m:10``): NSError domain
``com.alexrozanski.llama.error`` with codes Unknown=-1,
FailedToLoadModel=-1000, PredictionFailed=-1001.
"""

from __future__ import annotations

ERROR_DOMAIN = "com.alexrozanski.llama.error"


class LlamaError(Exception):
    """Base error; ``code`` mirrors the reference's NSError codes."""

    code = -1  # LlamaErrorCodeUnknown

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.domain = ERROR_DOMAIN
        self.message = message


class FailedToLoadModelError(LlamaError):
    """``LlamaErrorCodeFailedToLoadModel`` — bad path/magic/hparams/tensor
    shapes (raised by the loader for every case the reference maps to this
    code, ``LlamaPredictOperation.mm:101-498``)."""

    code = -1000


class PredictionFailedError(LlamaError):
    """``LlamaErrorCodePredictionFailed`` — eval-time failure
    (``LlamaPredictOperation.mm:543-545``)."""

    code = -1001
