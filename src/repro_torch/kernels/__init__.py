"""Hand-written Hopper kernels and their wrappers.

``fused_groupby`` wraps ``csrc/fused_groupby.cu`` (built at first use by
``build``); ``ops.groupby_kernel`` is the array front door onto the fused
route.  Nothing here builds or imports a compiler at import time.
"""
