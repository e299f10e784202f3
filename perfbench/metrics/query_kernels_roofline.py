"""The least bytes of the window's queries at the card's HBM rate, as a
share of the summed device time of every operation in the window."""
from perfbench.timeline import by_name_us


def read(run):
    if not run.device_ops or not run.query_bytes or not run.hbm_bytes_per_s:
        return None
    device_us = sum(by_name_us(run.device_ops).values())
    if device_us <= 0:
        return None
    least_us = run.query_bytes * len(run.done) / run.hbm_bytes_per_s * 1e6
    return 100.0 * least_us / device_us
