"""Frames stepped in the window over the window's seconds, from its
opening device synchronise to its closing one (host clock). The loop is
host-bound, so this follows the host's own speed, which differs between
runs of one seed by a fifth and more: it stands per layer, beside the
end-to-end device_ms_per_frame."""


def read(ctx):
    return ctx.frames / ctx.seconds
