"""Per call: the sum of the program's device spans of its kernel routes
(layer: kernels)."""

KERNEL_SPANS = ("phase 1", "phase 2", "rescan dp", "dp", "count_hot_batch", "corr",
                "dp batch", "corr batch", "conv batch")


def read(run):
    return run.span_ms(KERNEL_SPANS)
