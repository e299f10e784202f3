"""The executor's device table and accumulators at finalize
(``stats()["device"]["device_table_bytes"]``), the largest over the
window's queries, in MiB."""


def read(run):
    sizes = [q.stats["device"]["device_table_bytes"] for q in run.done
             if q.stats is not None]
    return max(sizes) / 2**20 if sizes else None
