"""Share of the traced stretch in which no kernel or copy ran on the card."""

from yardstick.trace_reads import idle_pct


def read(run, work):
    return idle_pct(work)
