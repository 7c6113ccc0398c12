"""Host milliseconds of the fused value-and-grad wrappers per K1 call:
the program's `vg.prepare` (K2 and the torch middle) and `vg.main` (the
weights and rays packed, K1's launch, the gradients unpacked) spans
outside their `wait.*` spans, over the count of `vg.main` spans."""

from slambench.program_spans import is_wait, window


def read(ctx):
    w = window(ctx)
    calls = 0 if w is None else w.count(lambda n: n == "vg.main")
    if not calls:
        return None
    return w.outside(lambda n: n in ("vg.prepare", "vg.main"),
                     is_wait) / calls * 1e3
