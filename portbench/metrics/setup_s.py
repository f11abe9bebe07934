"""setup_s: process start to the first timed step or request, without
the first run's kernel build (host clock)."""


def read(view):
    return view.setup_s
