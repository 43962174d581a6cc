"""The share of the rows the CCCNN ran on that carry a real item: the
generator's real hits (fleet) or strikes (drum) per call over the rows
``CCCNN.forward`` was given per call (the program's ``model_rows``
counter, which counts only while a profiler records: in the traced
window), in %.  The empty slots of the hit list's or the event list's
capacity make up the rest."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    try:
        from onset_fingerprinting_torch.utils.metrics import counters
    except ImportError:  # a program without counters
        return None
    rows = counters().get("model_rows", 0)
    if not rows:
        return None
    return 100.0 * ctx.items_per_call * ctx.calls / rows
