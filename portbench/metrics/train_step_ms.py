"""train_step_ms: the window's time over the steps it completed, the
last one synchronised (host clock)."""


def read(view):
    if view.kind != "train" or not view.count:
        return None
    return 1e3 * view.window_s / view.count
