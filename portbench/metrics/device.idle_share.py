"""The share (%) of the traced slice in which no operation ran on the
card (kernels, copies, fills, from torch.profiler's trace), averaged over
the cards the server uses."""
PROBES = {}


def read(calls, ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.busy:
        return None
    return 100.0 * (1.0 - tr.busy_s(ctx.n_devices) / tr.window_s)
