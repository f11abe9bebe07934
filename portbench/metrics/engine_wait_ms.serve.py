"""engine_wait_ms.serve: ``predict_batch``'s copies of the predictions
and targets to the host, which wait for the forward on the device, the
``aero.engine.to_host`` span, mean per profiled request."""

from portbench.program import span_ms


def read(view):
    return span_ms(view, ("aero.engine.to_host",)) if view.kind == "serve" \
        else None
