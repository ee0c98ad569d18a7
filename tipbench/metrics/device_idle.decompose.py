"""The device's idle share (%) of a request at the program's own pace:
1 - (busy time a traced request, from a profile of the device's activity
alone) / (wall time an untraced request of the same window)
(``trace.idle_share``).  None without a traced device."""
from tipbench import trace


def read(run):
    return trace.idle_share(run)
