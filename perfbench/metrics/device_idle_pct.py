"""Share of the traced window in which no device operation ran."""
from perfbench.timeline import busy_us


def read(run):
    if run.device_ops is None or run.window_s <= 0:
        return None
    busy = busy_us(run.device_ops, run.window_start_us, run.window_end_us)
    return 100.0 * (1.0 - busy / (run.window_end_us - run.window_start_us))
