"""Stream-seconds of audio fully processed (detected, every hit
fingerprinted or every event located and classified, outputs on the host)
over all the window's wall seconds."""


def read(ctx):
    return ctx.work / ctx.window_s if ctx.calls else None
