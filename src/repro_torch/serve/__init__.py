"""Serving: deployment to packed weights (``deploy``), sampling
(``sampling``) and the engine (``engine``).  Import the submodules
directly; this package imports nothing so that ``deploy`` can be loaded
by the model code without pulling in the engine."""
