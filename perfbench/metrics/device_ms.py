"""Device time a query: the traced window's busy time (the union of the
profiler's device operations) over the queries completed in it, in ms.  The
host's speed does not enter it, so it moves only with the device's work."""
from perfbench.timeline import busy_us


def read(run):
    if not run.device_ops or not run.done:
        return None
    busy = busy_us(run.device_ops, run.window_start_us, run.window_end_us)
    return busy / 1e3 / len(run.done) if busy > 0 else None
