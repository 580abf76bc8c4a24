"""Static analysis of the serving state (port of the part of
``repro.analysis`` the scheduler uses): the :class:`report.Finding`
record and the decode-state and scheduler contracts
(``contracts.validate_decode_state``, ``contracts.validate_scheduler``).
The wire-format (SW, BP), autotune (AT) and checkpoint (CK) rules, the
graph and sharding lints and the footprint census are not ported yet."""
