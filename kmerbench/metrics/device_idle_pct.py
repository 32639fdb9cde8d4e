"""Share of the traced window in which no operation ran on the device."""


def read(view):
    if not view.ops or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
