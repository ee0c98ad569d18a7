"""upload_mb.decompose: MB the program copies from the host to the card
per request (``stats.trace.upload_bytes``: the DGM matrices and vectors,
the FD stacks), mean over the traced run's window
(``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, lambda trace: trace.upload_bytes / 1e6)
