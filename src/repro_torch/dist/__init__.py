"""Distribution layer (port of ``repro.dist``): the logical-axis sharding
rules (:mod:`.sharding`) and the local shards and collectives that run a
sharded serving program on every rank (:mod:`.parallel`, the port's own).
The reference's HLO collective analysis (``hlo_analysis``) comes with the
dry run (ROADMAP item 6)."""
from . import parallel, sharding  # noqa: F401
