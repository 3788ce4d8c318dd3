"""idle_share.train: % of the profiled stretch in which no kernel and no copy
ran on the card."""


def read(view):
    return view.idle_share()
