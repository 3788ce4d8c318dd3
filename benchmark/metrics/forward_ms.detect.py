"""forward_ms.detect: ms of device time a call spends in the model forward
(models/, or quant.py in int8), from CUDA events around each forward of the
profiled stretch (a forward pre-hook and hook on the driver's model)."""

SPANS = {"forward": "@model"}


def read(view):
    return view.span_mean_ms("forward")
