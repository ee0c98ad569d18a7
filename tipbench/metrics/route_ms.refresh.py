"""route_ms.refresh: host ms per cycle routing the flush (the program's
span ``flush.route``: ``classify_refresh`` and the inserted and deleted
edge keys), mean over the traced run's window
(``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    value = program_spans.mean(run, program_spans.seconds("flush.route"))
    return None if value is None else 1e3 * value
