"""Column generators, one module a ``kind`` of a configuration's column.

Each module defines ``make(spec, rows, gen, device) -> torch.Tensor``: the
column's ``rows`` values drawn on ``device`` from ``gen`` (a
``torch.Generator`` on that device) as ``spec`` (the configuration's column
entry, merged with the traffic mix's) says.  Key columns are int32 bit
patterns of uint32 keys, the form the program's raw key columns take.
"""
