"""The port's error taxonomy (``errors``) and fault injection (``faults``),
copies of ``repro.api.errors`` and ``repro.api.faults``.  The planning and
execution layer arrives later."""
