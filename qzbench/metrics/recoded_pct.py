"""recoded_pct [%], layer dispatch: the share of the LZ4 device pack's
rows that the host's LZ4 coder codes again (rows not ``ok``, and empty
ones): the ``lz4_recoded`` over the ``lz4_rows`` counts of the program's
``finish`` spans in the window."""

from qzbench import program_spans


def read(run):
    spans = program_spans.window(run) or ()
    rows = sum(s.counts.get("lz4_rows", 0) for s in spans
               if s.name == "finish")
    if not rows:
        return None
    recoded = sum(s.counts.get("lz4_recoded", 0) for s in spans
                  if s.name == "finish")
    return 100.0 * recoded / rows
