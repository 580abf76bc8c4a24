"""Static analysis of the serving state (port of ``repro.analysis``'s
contracts): the :class:`report.Finding` record and the contract rules of
``contracts`` — deployed wire formats (SW, BP), checkpoints (CK), autotuned
and draft trees (AT), the decode state (PC, PA) and the scheduler (PX).
The graph and sharding lints and the footprint census are not ported
yet."""
