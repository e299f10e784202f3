"""Working memory of a query: the most any query's requests to the caching
allocator reached above what was requested as it opened (the resident
columns and the results kept for the check), in MiB."""


def read(run):
    peaks = [q.peak_bytes for q in run.done if q.peak_bytes is not None]
    return max(peaks) / 2**20 if peaks else None
