"""Known-good corpus for RL-SUPPRESS (port): a well-formed reasoned
disable."""


def fine():
    # reprolint: disable=RL-TRACERLEAK — demo: reasoned disables are welcome
    return 1.0
