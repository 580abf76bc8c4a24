"""Serving: deployment to packed weights (``deploy``), request types and
sampling (``sampling``), the engine (``engine``) and the
continuous-batching scheduler (``scheduler``).  The package exports the
request-level types; import the engine from ``serve.engine`` (this
package does not import it, so that ``deploy`` can be loaded by the
model code without pulling in the engine)."""
from .sampling import GenerationResult, Request, SamplingParams
from .scheduler import Scheduler

__all__ = ["GenerationResult", "Request", "SamplingParams", "Scheduler"]
