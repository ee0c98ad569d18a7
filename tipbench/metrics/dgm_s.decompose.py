"""dgm_s.decompose: host seconds of the CD phase's DGM per request (the
program's span ``cd.dgm``: every ``DeviceGraph`` built, host induce,
dense fill and upload, with its fresh state), mean over the traced run's
window (``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, program_spans.seconds("cd.dgm"))
