"""delta_s.refresh: host seconds per cycle in the service's support delta
(the program's span ``refresh.delta``: the union matrix built and
uploaded, the prime or the support deltas, their one read, the stop
ladder), mean over the traced run's window (``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, program_spans.seconds("refresh.delta"))
