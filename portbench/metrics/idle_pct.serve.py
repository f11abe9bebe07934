"""idle_pct.serve: the share of the traced requests' window in which no
kernel, copy or memset ran on the device."""

from portbench.readers import idle_pct


def read(view):
    return idle_pct(view) if view.kind == "serve" else None
