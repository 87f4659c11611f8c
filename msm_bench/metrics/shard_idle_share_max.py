"""shard_idle_share_max: the highest idle share (1 - busy / traced window)
among the cards of a sharded cell; nothing on one card."""


def read(run):
    if run.trace is None or len(run.trace.cards) < 2:
        return None
    return max(1 - c.busy_s / run.trace.window_s for c in run.trace.cards.values())
