"""Host ms a batch inside calls into the program (`port.*` spans: from
the call to its return, the harness's waits excluded)."""


def read(view):
    if not view.batches:
        return None
    return 1e3 * view.port_s / view.batches
