"""idle_share: 1 - busy / traced window, busy being the union of a card's
kernel, copy and fill intervals; the mean over the cell's cards."""


def read(run):
    if run.trace is None or not run.trace.cards:
        return None
    cards = run.trace.cards.values()
    return sum(1 - c.busy_s / run.trace.window_s for c in cards) / len(cards)
