"""#2 co-occurrence counts (``ops.cooccurrence_counts``): a step counts the
self occurrences of the 3B rows and the cross ones of the 4B pair rows.
Operations: the least work that gives the counts, a sort of each row's
keys and two binary searches a query (3 l log2 l compares a row)."""
import math

from port_bench import workmath

KIND = "kernel"
ANCHOR = r"cooccurrence_(pairs|table)_kernel"


def calls(cell):
    if cell["cfg"]["model"] != "DyGFormer":
        return []
    m, lp, *_ = workmath.dygformer(cell)
    b = m // 3
    return [(3 * r * lp * math.log2(lp), 4 * 3 * r * lp) for r in (3 * b, 4 * b)]
