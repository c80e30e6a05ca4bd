"""ratio [x]: the input bytes of every request completed in the window
over their output bytes: bytes stored per byte of user data."""


def read(run):
    out = sum(r.bytes_out for r in run.requests)
    if not out:
        return None
    return sum(r.bytes_in for r in run.requests) / out
