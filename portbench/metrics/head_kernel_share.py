"""The share of the rows the CCCNN ran on whose head ran on the head kernel
(``csrc/cccnn_head.cu``): the program's ``head_kernel_rows`` counter over
its ``model_rows`` counter (both kept only while a profiler records: in the
traced window), in %.  A program without the head kernel keeps no
``head_kernel_rows``: nothing to read."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    try:
        from onset_fingerprinting_torch.utils.metrics import counters
    except ImportError:  # a program without counters
        return None
    counts = counters()
    rows, head = counts.get("model_rows", 0), counts.get("head_kernel_rows")
    if not rows or head is None:
        return None
    return 100.0 * head / rows
