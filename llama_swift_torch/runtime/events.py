"""Lifecycle events and run states.

Parity with the reference's event layer:

* ``_LlamaEvent`` tagged union + ``match`` visitor
  (``Sources/llamaObjCxx/bridge/LlamaEvent.mm:10-114``): startedLoadingModel,
  finishedLoadingModel, startedGeneratingOutput, outputToken(token),
  completed, failed(error).
* ``LlamaRunner.RunState`` (``Sources/llama/LlamaRunner.swift:34-40``):
  notStarted → initializing → generatingOutput → completed / failed.

(The reference header comically names every ``match`` closure parameter
``startedLoadingModel`` — ``headers/LlamaEvent.h:21-26``; we do not replicate
that quirk.)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class EventKind(enum.Enum):
    STARTED_LOADING_MODEL = "startedLoadingModel"
    FINISHED_LOADING_MODEL = "finishedLoadingModel"
    STARTED_GENERATING_OUTPUT = "startedGeneratingOutput"
    OUTPUT_TOKEN = "outputToken"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class Event:
    kind: EventKind
    token: Optional[str] = None
    error: Optional[BaseException] = None

    # -- factory ctors (LlamaEvent.mm:31-83) -----------------------------
    @staticmethod
    def started_loading_model() -> "Event":
        return Event(EventKind.STARTED_LOADING_MODEL)

    @staticmethod
    def finished_loading_model() -> "Event":
        return Event(EventKind.FINISHED_LOADING_MODEL)

    @staticmethod
    def started_generating_output() -> "Event":
        return Event(EventKind.STARTED_GENERATING_OUTPUT)

    @staticmethod
    def output_token(token: str) -> "Event":
        return Event(EventKind.OUTPUT_TOKEN, token=token)

    @staticmethod
    def completed() -> "Event":
        return Event(EventKind.COMPLETED)

    @staticmethod
    def failed(error: BaseException) -> "Event":
        return Event(EventKind.FAILED, error=error)

    # -- visitor (LlamaEvent.mm:85-114) ----------------------------------
    def match(
        self,
        started_loading_model: Optional[Callable[[], None]] = None,
        finished_loading_model: Optional[Callable[[], None]] = None,
        started_generating_output: Optional[Callable[[], None]] = None,
        output_token: Optional[Callable[[str], None]] = None,
        completed: Optional[Callable[[], None]] = None,
        failed: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        k = self.kind
        if k == EventKind.STARTED_LOADING_MODEL and started_loading_model:
            started_loading_model()
        elif k == EventKind.FINISHED_LOADING_MODEL and finished_loading_model:
            finished_loading_model()
        elif k == EventKind.STARTED_GENERATING_OUTPUT and started_generating_output:
            started_generating_output()
        elif k == EventKind.OUTPUT_TOKEN and output_token:
            output_token(self.token or "")
        elif k == EventKind.COMPLETED and completed:
            completed()
        elif k == EventKind.FAILED and failed:
            failed(self.error or RuntimeError("unknown"))


class RunState(enum.Enum):
    """``LlamaRunner.RunState`` (``LlamaRunner.swift:34-40``)."""

    NOT_STARTED = "notStarted"
    INITIALIZING = "initializing"
    GENERATING_OUTPUT = "generatingOutput"
    COMPLETED = "completed"
    FAILED = "failed"
