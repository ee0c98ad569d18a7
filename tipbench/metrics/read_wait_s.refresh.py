"""read_wait_s.refresh: host seconds per cycle in the program's blocking
device-to-host reads (the span ``read`` around each ``fetch``: the
delta's one read and the re-peel's one a sweep), mean over the traced
run's window (``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, program_spans.seconds("read"))
