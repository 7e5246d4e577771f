"""exchange.copied_pct: the share of the due ghost entries that the
boundary exchanges wrote, in %: the program's counter ``exchange.entries``
over its counter ``exchange.entries_due`` (the entries of the lanes and
rounds each exchange was due to refresh, which a pull copies whole) over
the traced window.  100 where every exchange pulls; lower where the
recoloring loop pushes only what its runs recolored.  None where the
program has no ``exchange.entries_due``."""
from colorbench import program_spans


def read(run):
    due = program_spans.counter(run, "exchange.entries_due")
    if not due:
        return None
    return 100.0 * (program_spans.counter(run, "exchange.entries")
                    or 0) / due
