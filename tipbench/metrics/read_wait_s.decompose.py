"""read_wait_s.decompose: host seconds per request in the program's
blocking device-to-host reads (the span ``read`` around each ``fetch``,
in CD and FD: the wait for the queued work, and the copy), mean over the
traced run's window (``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, program_spans.seconds("read"))
