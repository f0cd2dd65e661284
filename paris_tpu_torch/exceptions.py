"""Two-tier framework exceptions (reference: src/exception.h:31-41).

The reference drives its top-level error handling off exactly two
exception types — ``stage_construction_error`` (thrown while building a
pipeline stage: bad geometry, unopenable files, failed allocations) and
``stage_runtime_error`` (thrown while a stage is processing data) — both
caught in ``main`` (src/main.cpp:181-192) and turned into a fatal log +
exit code.  We keep the same two-phase split so callers can distinguish
"the job could never start" from "the job died mid-flight":

  * ``StageConstructionError`` — raised while constructing a pipeline
    (geometry derivation, planner, source/sink open, backend selection).
  * ``StageRuntimeError`` — raised while streaming projections through
    a constructed pipeline (decode failures, device errors, IO errors).

Both derive from ``ParisError`` so library users can catch everything
with one handler; format-level errors (``HisFormatError``,
``DdbvfFormatError``, ``NativeIoError``) stay subclasses of the stdlib
types they refine but are re-raised wrapped at the app layer.
"""

__all__ = ["ParisError", "StageConstructionError", "StageRuntimeError"]


class ParisError(Exception):
    """Base class for all paris_tpu framework errors."""


class StageConstructionError(ParisError, ValueError):
    """A pipeline stage could not be constructed (reference exception.h:31).

    Also a ``ValueError`` so pre-existing callers that catch the stdlib
    type keep working.
    """


class StageRuntimeError(ParisError, RuntimeError):
    """A constructed pipeline stage failed while processing (exception.h:37)."""
