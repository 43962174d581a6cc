"""Process start to the first timed call: imports, the card's context,
inputs and weights made from the seed, the kernels' build where the
checkout has none yet, and the warm-up calls.  A run whose set-up built
kernels says so: ``built_kernels`` in its result line counts them, and its
``detail built_kernels`` line names them."""


def read(ctx):
    return ctx.setup_s
