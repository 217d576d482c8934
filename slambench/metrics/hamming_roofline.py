"""The windowed Hamming search kernel's share of its roofline: the least
time its launches could take on the chip (``roofline/hamming.py``:
the larger of the pairs' population counts over the published rate and
its bytes over HBM bandwidth), over the time its kernels took, for the
launches whose inputs the traced sub-window kept."""


def read(ctx):
    if ctx.roofline is None:
        return None
    least, spent, _ = ctx.roofline
    return 100.0 * least / spent if least > 0 and spent > 0 else None
