"""The 90th percentile of the window's query times (host clock, from the
stream's opening to its result, synchronized), in ms."""
import statistics


def read(run):
    ms = [q.seconds * 1e3 for q in run.done]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
