"""Device kernels, copies and fills a frame over the traced stretch (the
harness's own copies left out)."""


def read(t):
    return t.events_per_step() if t.device else None
